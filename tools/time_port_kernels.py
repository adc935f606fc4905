#!/usr/bin/env python3
"""Time the port's ShockCooling2 kernels K1, K2, K6a and K9 on one CUDA card
at the shapes of ``chip_smoke.py`` (K1 at 131072 walkers, K2 per half-step
of 131072, K6a per ladder half-step of 17 rungs x 4096, K9 per NUTS
transition of 64 and of 16 whitened flagship chains at eps 0.1, max_depth
9), float32 compute, by CUDA events.

Usage: ``python3 tools/time_port_kernels.py [--repo PATH] [--label NAME]``.
``--repo`` is the checkout whose ``lightcurve_fitting_tpu_torch`` is timed
(default: this one), so that two versions can be compared on one card, in
turns: run it on each checkout in the order A, B, B, A on the same machine.
Each run builds its checkout's kernels first. The last line of
the output is one JSON object with the card, its power limit and each
kernel's milliseconds (the minimum over the repeats, and all repeats).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
P_LO = [20.0, 2.0, 20.0, 57468.5]
P_UP = [50.0, 5.0, 50.0, 57468.7]
TRUTH_MED = [37.58, 5.326, 16.25, 57468.6999]
TRUTH_STD = [0.145, 0.053, 0.110, 0.00018]


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_port_kernels: CUDA is not available; this script runs on the GPU")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import build, gradient, ladder, sc2
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    from lightcurve_fitting_tpu_torch.models import GaussianPrior, ShockCooling2, UniformPrior
    from lightcurve_fitting_tpu_torch.parallel.evidence import make_beta_ladder
    from lightcurve_fitting_tpu_torch.parallel.hmc import (BoundsTransform, WhitenedLogPosterior,
                                                           WhitenedPosterior)
    build.library()
    dev = torch.device("cuda")
    lc = LC.read(os.path.join(repo, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    lc = lc.where(MJD_min=57468.0, MJD_max=57485.0)
    priors = [UniformPrior(0.0, 100.0), UniformPrior(0.0, 100.0), UniformPrior(0.0, 100.0),
              UniformPrior(57468.0, 57468.7)]
    lp = make_log_posterior(ShockCooling2(lc), lc, priors, device=dev)
    kw = _state_rescaling(torch.float32, P_LO, P_UP, dev)
    off, sc = kw["param_offset"], kw["param_scale"]
    rng = np.random.default_rng(0)
    times = {}

    # K1 at 131072 walkers, K2 per half-step of 131072 (float32 rescaled state)
    W = 131072
    half = W // 2
    p = torch.as_tensor(rng.uniform(P_LO, P_UP, size=(W, 4)), device=dev)
    times["K1"] = events_ms(lambda: sc2.log_posterior(lp, p), 20, args.repeats)
    x = torch.as_tensor(((p.cpu().numpy() - off) / sc).reshape(2, half, 4),
                        device=dev).float().contiguous()
    logp = sc2.log_posterior(lp, x.reshape(W, 4), off, sc).reshape(2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    u_z = torch.rand(half, generator=g, device=dev)
    j = torch.randint(0, half, (half,), generator=g, device=dev)
    u_acc = torch.rand(half, generator=g, device=dev)
    acc = torch.zeros((2, half), dtype=torch.int32, device=dev)
    times["K2"] = events_ms(lambda: sc2.stretch_half_step(lp, x, logp, 0, u_z, j, u_acc, 2.0, off,
                                                          sc, n_accept=acc,
                                                          check_partners=False),
                            20, args.repeats)

    # K6a: one ladder half-step of 17 rungs x 4096 walkers
    R, Wl = 17, 4096
    q = (rng.uniform(P_LO, P_UP, size=(R * Wl, 4)) - off) / sc
    xl = torch.as_tensor(q.reshape(R, 2, Wl // 2, 4), device=dev).float().contiguous()
    pri, ll = ladder.ladder_init(lp, xl, off, sc)
    betas = torch.as_tensor(make_beta_ladder(R - 1), device=dev)
    shape = (R, 2, Wl // 2)
    uz = torch.rand(shape, generator=g, device=dev)
    jl = torch.randint(0, Wl // 2, shape, generator=g, device=dev)
    ua = torch.rand(shape, generator=g, device=dev)
    al = torch.zeros(shape, dtype=torch.int32, device=dev)
    times["K6a"] = events_ms(lambda: ladder.tempered_half_step(lp, xl, pri, ll, betas, 0, uz, jl,
                                                               ua, 2.0, off, sc, al,
                                                               check_partners=False),
                             20, args.repeats)

    # K9: one NUTS transition of 64 and of 16 whitened flagship chains
    gpri = [GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(0.0, 100.0, 4.0, 3.0),
            GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(57468.0, 57468.7, 57468.5, 0.2)]
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
    q16, l16, z16, u16 = (a[:16].contiguous() for a in (q0, logp0, z, u))
    times["K9_16"] = events_ms(lambda: gradient.nuts_transition(target, q16, l16, z16, u16, eps,
                                                                inv_mass, D), 5, args.repeats)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    for k, v in times.items():
        print(f"[time_port_kernels] {args.label} {k}: min {min(v):.4f} ms, repeats "
              f"{', '.join(f'{t:.4f}' for t in v)}", flush=True)
    print(json.dumps({"label": args.label, "repo": repo, "card": smi,
                      "ms": {k: min(v) for k, v in times.items()}, "repeats": times}), flush=True)


if __name__ == "__main__":
    main()
