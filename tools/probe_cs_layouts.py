#!/usr/bin/env python3
"""Time the companion-shocking half-step and K6a over CS of one checkout at
the fits' widths, for comparing layouts of those kernels on one card.

The widths: the CS half-step at half 16 (the 32-walker fit), 16384 (the
32768-walker fit) and 65536; K6a at 7 rungs x 64 walkers (the PT fit) and
17 x 4096 (the evidence), CompanionShocking2 on ``chip_smoke.py``'s
synthetic Ia curve, float32 rescaled state. Each is timed by CUDA events
around a run of launches (7 repeats) and by the profiler's device time (5
repeats; the kernel alone, whatever the wrapper's host time), and one step
from a fixed start is hashed: two layouts whose digests agree compute the
same bits. The ptxas report of the float32 kernels closes the output.

Usage: ``python3 tools/probe_cs_layouts.py --repo PATH --label NAME``, one
run a checkout (a copy of the tree with the layout changed), in turns on
one card. ``tools/time_port_kernels.py`` times every kernel; this times
these two alone, in a third of its time.
"""

import argparse
import os
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_cs_layouts: CUDA is not available; this script runs on the GPU")
    sys.path.insert(0, os.path.abspath(args.repo))
    from time_port_kernels import device_ms, digest, events_ms, ptxas_report
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import build, cs, ladder
    from lightcurve_fitting_tpu_torch.parallel.evidence import make_beta_ladder
    import chip_smoke   # the checkout's own: its synthetic Ia curve and CS window
    build.library()
    dev = torch.device("cuda")
    lc_ia, lc0 = chip_smoke.ia_lc()
    lo, up = chip_smoke.CS_LO[2], chip_smoke.CS_UP[2]
    lp = make_log_posterior(chip_smoke.cs_model(2, lc0), lc_ia, chip_smoke.cs_priors(2),
                            device=dev)
    kw = _state_rescaling(torch.float32, lo, up, dev)
    off, sc = kw["param_offset"], kw["param_scale"]
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev)
    out = {}

    def timed(name, step, kernel, launches, hashed):
        out[name] = (events_ms(step, launches, 7), device_ms(step, kernel, launches, 5), hashed)

    for h in (16, 16384, 65536):
        x = torch.as_tensor((rng.uniform(lo, up, size=(2 * h, 7)) - off) / sc, device=dev)
        x = x.float().reshape(2, h, 7).contiguous()
        logp = cs.log_posterior(lp, x.reshape(2 * h, 7), off, sc).reshape(2, h)
        g.manual_seed(17)
        u_z = torch.rand(h, generator=g, device=dev)
        j = torch.randint(0, h, (h,), generator=g, device=dev)
        u_acc = torch.rand(h, generator=g, device=dev)
        xd, ld = x.clone(), logp.clone()
        ad = torch.zeros((2, h), dtype=torch.int32, device=dev)
        cs.stretch_half_step(lp, xd, ld, 0, u_z, j, u_acc, 2.0, off, sc, n_accept=ad)
        acc = torch.zeros((2, h), dtype=torch.int32, device=dev)
        timed(f"half_{h}", lambda: cs.stretch_half_step(
            lp, x, logp, 0, u_z, j, u_acc, 2.0, off, sc, n_accept=acc, check_partners=False),
            "stretch_half_step_kernel", 20 if h > 16 else 100, digest(xd, ld, ad))
    for R, h in ((7, 32), (17, 2048)):
        q = (rng.uniform(lo, up, size=(R * 2 * h, 7)) - off) / sc
        x = torch.as_tensor(q.reshape(R, 2, h, 7), device=dev).float().contiguous()
        pri, ll = ladder.ladder_init(lp, x, off, sc)
        betas = torch.as_tensor(make_beta_ladder(R - 1), device=dev)
        shape = (R, 2, h)
        g.manual_seed(18)
        u_z = torch.rand(shape, generator=g, device=dev)
        j = torch.randint(0, h, shape, generator=g, device=dev)
        u_acc = torch.rand(shape, generator=g, device=dev)
        xd, pd, ld = x.clone(), pri.clone(), ll.clone()
        ad = torch.zeros(shape, dtype=torch.int32, device=dev)
        ladder.tempered_half_step(lp, xd, pd, ld, betas, 0, u_z, j, u_acc, 2.0, off, sc, ad)
        acc = torch.zeros(shape, dtype=torch.int32, device=dev)
        timed(f"k6a_{R}x{2 * h}", lambda: ladder.tempered_half_step(
            lp, x, pri, ll, betas, 0, u_z, j, u_acc, 2.0, off, sc, acc, check_partners=False),
            "tempered_half_step_kernel", 20 if R * h > 1024 else 100, digest(xd, pd, ld, ad))
    for k, (ev, de, dg) in out.items():
        print(f"[probe] {args.label} {k}: events min {min(ev):.4f} median {np.median(ev):.4f} ms; "
              f"device min {min(de):.4f} median {np.median(de):.4f} ms; digest {dg}", flush=True)
    for k, v in ptxas_report(build.build_info()["log"]).items():
        if "CSWarpModelIfLi0EEfff" in k or "tempered_half_step_kernelI11CSWarpModelIfLi0EEf" in k:
            print(f"[probe] {args.label} ptxas {k}: registers {v[0]}, stack frame {v[1]} bytes, "
                  f"spill stores {v[2]}, spill loads {v[3]}", flush=True)


if __name__ == "__main__":
    main()
