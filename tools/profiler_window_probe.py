"""How many of a profiler window's kernels the profiler records, on the card.

Each window profiles 20 launches of K7 at 131072 walkers (about 1 ms each,
the check of ``chip_smoke.py`` phase 20 that once came back empty) on the
CUDA activity alone, as ``chip_smoke.launched_kernels`` does, and prints one
JSON line: the kernels recorded of the 20 and where the first recorded one
starts in the window.

    python3 tools/profiler_window_probe.py trace     # before and after 13c's min_nfilt=1 run, profiled
    python3 tools/profiler_window_probe.py notrace   # the same run, unprofiled
    python3 tools/profiler_window_probe.py idle      # windows after 0, 60, 60, 120 and 120 s asleep
    python3 tools/profiler_window_probe.py primed    # windows after 0, 60, 120 and 120 s asleep, primed

In ``trace`` and ``notrace`` a battery of windows (K7 at 131072 and at 64
walkers, with the CPU activity too, an elementwise kernel, a 0.2 s wait
after the launches, and 256 one-element adds launched first) runs before
the long run, after it, and after a garbage collection. In ``idle`` each
stage profiles twice plainly, then with a wait of 0.1 and of 0.5 s inside
the window before the launches; in ``primed`` each stage's first and
third windows launch 256 and 4096 one-element adds first, the second and
fourth none. Needs one card; run it from the root of a checkout.
"""

import contextlib
import gc
import io
import json
import os
import sys
import tempfile
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lightcurve_fitting_tpu_torch.fitting import make_log_posterior  # noqa: E402
from lightcurve_fitting_tpu_torch.kernels import build, sc2  # noqa: E402
from lightcurve_fitting_tpu_torch.models import ShockCooling2  # noqa: E402

CALLS = 20


def window(label, fn, match, t_start, cpu=False, head=0.0, tail=0.0, prime=0):
    """Profile CALLS calls of fn and print what the profiler recorded; with
    ``prime``, that many one-element adds are launched first in the window
    (``primed_recorded``: how many of them the profiler kept)."""
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    one = torch.zeros(1, device="cuda")
    with profile(activities=acts) as prof:
        if head:
            time.sleep(head)
        for _ in range(prime):
            one.add_(1.0)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        if tail:
            time.sleep(tail)
    res = prof.profiler.kineto_results
    ev = res.events()
    kern = [e for e in ev if e.device_type().name == "CUDA" and match in e.name()]
    launches = [e for e in ev if "cudaLaunch" in e.name() or "cuLaunch" in e.name()]
    info = dict(label=label, age_s=round(time.perf_counter() - t_start, 1), head_s=head,
                tail_s=tail, cpu=cpu, prime=prime, recorded=len(kern), of=CALLS,
                launches_seen=len(launches))
    if prime:
        info["primed_recorded"] = sum(e.device_type().name == "CUDA" and "elementwise" in e.name()
                                      for e in ev)
    if kern:
        info["first_kernel_after_window_start_ms"] = round(
            (min(k.start_ns() for k in kern) - res.trace_start_ns()) / 1e6, 2)
    print(json.dumps(info), flush=True)


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode not in ("trace", "notrace", "idle", "primed"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_window_probe: CUDA is not available")
    t_start = time.perf_counter()
    build.library()
    dev = torch.device("cuda")
    lc = cs.flagship_lc()
    lp = make_log_posterior(ShockCooling2(lc), lc, cs.flagship_priors(), device=dev)
    p = torch.as_tensor(np.random.default_rng(10).uniform(cs.P_LO, cs.P_UP, size=(131072, 4)),
                        device=dev)
    small = p[:64].contiguous()
    ones = torch.ones(1024, device=dev)

    def k7():
        sc2.log_posterior_and_grad(lp, p)

    if mode == "idle":
        for stage, wait in enumerate((0, 60, 60, 120, 120)):
            time.sleep(wait)
            for head in (0.0, 0.0, 0.1, 0.5):
                window(f"stage {stage}", k7, "logpost_grad", t_start, head=head)
        return
    if mode == "primed":
        for stage, wait in enumerate((0, 60, 120, 120)):
            time.sleep(wait)
            for prime in (256, 0, 4096, 0):
                window(f"stage {stage}", k7, "logpost_grad", t_start, prime=prime)
        return

    def battery(tag):
        window(f"{tag} K7 131072", k7, "logpost_grad", t_start)
        window(f"{tag} K7 131072", k7, "logpost_grad", t_start)
        window(f"{tag} K7 64", lambda: sc2.log_posterior_and_grad(lp, small), "logpost_grad",
               t_start)
        window(f"{tag} K7 131072", k7, "logpost_grad", t_start, cpu=True)
        window(f"{tag} add", lambda: torch.add(ones, 1.0), "elementwise", t_start)
        window(f"{tag} K7 131072", k7, "logpost_grad", t_start, tail=0.2)
        window(f"{tag} K7 131072", k7, "logpost_grad", t_start, prime=256)

    from lightcurve_fitting_tpu_torch import bolometric as tbol
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    lc0 = LC.read(os.path.join(REPO, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
    lc0.meta.update(cs.META)
    outdir = tempfile.mkdtemp(prefix="profiler_window_probe_")

    def run():
        with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
            warnings.simplefilter("ignore")
            tbol.calculate_bolometric(lc0.copy(), batch_mode=False, save_corners=False, seed=7,
                                      outpath=outdir, min_nfilt=1)

    battery("before")
    t0 = time.perf_counter()
    if mode == "trace":
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = sum(e.device_type().name == "CUDA" for e in prof.profiler.kineto_results.events())
        prof.key_averages()
        print(json.dumps(dict(label="13c min_nfilt=1 run, profiled", wall_s=round(wall, 3),
                              cuda_events=n,
                              reduce_s=round(time.perf_counter() - t0 - wall, 1))), flush=True)
        del prof
    else:
        run()
        torch.cuda.synchronize()
        print(json.dumps(dict(label="13c min_nfilt=1 run, unprofiled",
                              wall_s=round(time.perf_counter() - t0, 3))), flush=True)
    battery("after")
    gc.collect()
    battery("after gc")


if __name__ == "__main__":
    main()
