#!/usr/bin/env python3
"""Where one walker's time goes in the ShockCooling (SW17) and ShockCooling4
(MSW23) stretch half-steps of one checkout, on one CUDA card.

The warp form (``stretch_half_step_kernel`` over
``SCWarpModel`` / ``SC4WarpModel``: a warp per walker, lane l on the points
l, l + 32, ...) in a copy of the checkout's package whose kernel source has
``clock64()`` stamps put in at the phases of a walker: the block's staging
of the per-point table (with its ``__syncthreads``), the walker's prologue
(proposal, prior, the model's walker constants), the lanes' point loop, the
butterfly and the finish, the accept and its writes; plus each warp's
``%globaltimer`` at entry and exit and its SM. Lane 0 of every warp writes
them after a ``__syncwarp()``, so a phase is the warp's, not a lane's.
Printed: each phase's median and largest cycles over the warps (medians
over the launches), the cycles per nanosecond of the run (clock64 against
globaltimer between a warp's entry and exit), the spread of the blocks'
entry times, and the kernel's device time by the profiler (the stamps
included). The same launches without the likelihood (every proposal
outside the priors: the kernel minus the walker constants and points) and
a one-element add (a kernel with no work) are timed beside it.

Usage: ``python3 tools/probe_sc_latency.py [--repo PATH] [--label NAME]``
(``--repo``: the checkout whose kernels are stamped, default this one). The
last line is one JSON object with the card and every number printed. Both
forms' device times over widths are ``tools/time_port_kernels.py
--sc-only --sc-halves``'s.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
# examples/compare_models.py's window (chip_smoke.py's SC_LO, SC_UP)
SC_LO = [0.5, 0.5, 0.1, 0.1, 57468.3]
SC_UP = [10.0, 20.0, 10.0, 20.0, 57468.7]
SLOTS = 10            # per warp: 6 clock64 stamps, globaltimer at entry and exit, SM, exit clock
STAMP_WARPS = 4096
PHASES = ("staging", "prologue", "points", "butterfly", "accept")

# the stamps, put into a copy of csrc/stretch.cuh and csrc/sc_logpost.cu
# (anchor, replacement); each anchor must occur once
STAMP_DEFS = r"""
#define LCF_STAMP_WARPS %d
#define LCF_STAMP_SLOTS %d
static __device__ long long lcf_stamps[LCF_STAMP_WARPS * LCF_STAMP_SLOTS];
__device__ __forceinline__ long long lcf_globaltimer() {
    long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    return t;
}
__device__ __forceinline__ long long lcf_smid() {
    int s;
    asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(s));
    return (long long)s;
}
#define LCF_PUT(k, v) do { \
    const int lcf_w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); \
    if ((threadIdx.x & 31) == 0 && lcf_w < LCF_STAMP_WARPS) \
        lcf_stamps[lcf_w * LCF_STAMP_SLOTS + (k)] = (v); } while (0)
#define LCF_CLOCK(k) do { __syncwarp(); LCF_PUT(k, clock64()); } while (0)
""" % (STAMP_WARPS, SLOTS)

STRETCH_PATCHES = [
    ("#define LP_THREADS 128\n", "#define LP_THREADS 128\n" + STAMP_DEFS),
    ("""    const typename M::Data d = M::stage(P, smem_raw, use_smem, e);
    const int per_block = blockDim.x >> 5;
    const int bsz = M::batched ? batch : 1;   // (a constant 1 when not batched)
    const int n_batches = (half + bsz - 1) / bsz;
""", """    LCF_PUT(6, lcf_globaltimer());
    LCF_CLOCK(0);
    const typename M::Data d = M::stage(P, smem_raw, use_smem, e);
    LCF_CLOCK(1);
    const int per_block = blockDim.x >> 5;
    const int bsz = M::batched ? batch : 1;   // (a constant 1 when not batched)
    const int n_batches = (half + bsz - 1) / bsz;
"""),
    ("""                                    n_accept, draw_stride, e, b0,
                                    M::batched && half - b0 < bsz ? half - b0 : bsz);
    }
""", """                                    n_accept, draw_stride, e, b0,
                                    M::batched && half - b0 < bsz ? half - b0 : bsz);
        LCF_CLOCK(5);
    }
    LCF_CLOCK(9);
    LCF_PUT(7, lcf_globaltimer());
    LCF_PUT(8, lcf_smid());
"""),
    ("""        if (isfinite(lprior)) wk = M::walker(p, P);
    }
    const double ll = warp_batch_ll<M>(wk, lprior, nb, d, P);
    if (lane >= nb) return;
    half_step_accept<D>(""", """        if (isfinite(lprior)) wk = M::walker(p, P);
    }
    LCF_CLOCK(2);
    const double ll = warp_batch_ll<M>(wk, lprior, nb, d, P);
    LCF_CLOCK(4);
    if (lane >= nb) return;
    half_step_accept<D>("""),
]
SC_PATCHES = [
    ("""    for (int n = threadIdx.x & 31; n < N; n += 32) acc = add_rn(acc, term(n));
    return finish_log_likelihood<C>(""", """    for (int n = threadIdx.x & 31; n < N; n += 32) acc = add_rn(acc, term(n));
    LCF_CLOCK(3);
    return finish_log_likelihood<C>("""),
]
SC_READER = """
extern "C" int sc_probe_stamps(long long* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, lcf_stamps, sizeof(long long) * n);
}
extern "C" int sc_probe_clear() {
    void* p = nullptr;
    int rc = (int)cudaGetSymbolAddress(&p, lcf_stamps);
    return rc ? rc : (int)cudaMemset(p, 0, sizeof(lcf_stamps));
}
"""


def patch(path, patches, tail=""):
    with open(path) as f:
        src = f.read()
    for anchor, new in patches:
        if src.count(anchor) != 1:
            raise SystemExit(f"probe_sc_latency: {os.path.basename(path)} has {src.count(anchor)} "
                             f"copies of the anchor {anchor.strip().splitlines()[0]!r}")
        src = src.replace(anchor, new)
    with open(path, "w") as f:
        f.write(src + tail)


def stamped_copy(repo):
    """A copy of repo's package (and a link to its data) with the stamps."""
    root = tempfile.mkdtemp(prefix="sc_stamps_")
    pkg = os.path.join(root, "lightcurve_fitting_tpu_torch")
    shutil.copytree(os.path.join(repo, "lightcurve_fitting_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    os.symlink(os.path.join(repo, "lightcurve_fitting_tpu"),
               os.path.join(root, "lightcurve_fitting_tpu"))
    csrc = os.path.join(pkg, "kernels", "csrc")
    patch(os.path.join(csrc, "stretch.cuh"), STRETCH_PATCHES)
    patch(os.path.join(csrc, "sc_logpost.cu"), SC_PATCHES, SC_READER)
    return root


def flagship(repo):
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    lc = LC.read(os.path.join(repo, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


def sc_priors():
    from lightcurve_fitting_tpu_torch.models import LogUniformPrior, UniformPrior
    return [UniformPrior(0.1, 20.0), UniformPrior(0.1, 30.0), LogUniformPrior(0.01, 100.0),
            UniformPrior(0.01, 50.0), UniformPrior(57468.0, 57468.7)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_sc_latency: CUDA is not available; this script runs on the GPU")
    repo = os.path.abspath(args.repo)
    root = stamped_copy(repo)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    from time_port_kernels import device_ms, ptxas_report
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import build, sc
    from lightcurve_fitting_tpu_torch import models
    lib = build.library()
    ptxas = {k: v for k, v in ptxas_report(build.build_info()["log"]).items()
             if "SCWarpModel" in k or "SC4WarpModel" in k}
    dev = torch.device("cuda")
    lc = flagship(repo)
    kw = _state_rescaling(torch.float32, SC_LO, SC_UP, dev)
    off, scale = kw["param_offset"], kw["param_scale"]
    g = torch.Generator(device=dev)
    out = {"label": args.label, "repo": repo}
    lines = []

    def state(half, seed, outside=False):
        rng = np.random.default_rng(seed)
        pos = rng.uniform(SC_LO, SC_UP, size=(2 * half, 5))
        if outside:
            pos[:, 0] = 25.0   # v_s* above its prior: every proposal's too
        x = torch.as_tensor((pos - off) / scale, device=dev).float()
        return x.reshape(2, half, 5).contiguous()

    def draws(half, seed):
        g.manual_seed(seed)
        return (torch.rand(half, generator=g, device=dev),
                torch.randint(0, half, (half,), generator=g, device=dev),
                torch.rand(half, generator=g, device=dev))

    one = torch.zeros(1, device=dev)
    out["add1_dev"] = device_ms(lambda: one.add_(1.0), "elementwise", 100, 5)
    lines.append(f"add1 (a kernel with no work): device {min(out['add1_dev']):.4f} ms")

    for name in ("ShockCooling", "ShockCooling4"):
        prefix = "sc" if name == "ShockCooling" else "sc4"
        lp = make_log_posterior(getattr(models, name)(lc), lc, sc_priors(), device=dev)
        lib.sc_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        # the warp form, in a checkout that has another
        fkw = {"form": "warp"} if "form" in sc.half_step_launch.__code__.co_varnames else {}
        buf = np.zeros(STAMP_WARPS * SLOTS, dtype=np.int64)
        for half in (32, 2048):
            x0 = state(half, half)
            l0 = sc.logpost_launch(prefix, lp, x0.reshape(-1, 5), off, scale).reshape(2, half)
            u_z, j, u_acc = draws(half, half + 1)
            acc = torch.zeros((2, half), dtype=torch.int32, device=dev)
            per_launch = {k: [] for k in PHASES + ("entry_spread_ns", "warp_ns",
                                                  "cycles_per_ns")}
            n_warps = None
            for rep in range(args.launches + 1):
                x, lg = x0.clone(), l0.clone()
                if lib.sc_probe_clear() != 0:
                    raise RuntimeError("sc_probe_clear failed")
                sc.half_step_launch(prefix, lp, x, lg, 0, u_z, j, u_acc, 2.0, off, scale,
                                    n_accept=acc, check_partners=False, **fkw)
                torch.cuda.synchronize()
                if lib.sc_probe_stamps(buf.ctypes.data, buf.size) != 0:
                    raise RuntimeError("sc_probe_stamps failed")
                s = buf.reshape(STAMP_WARPS, SLOTS)
                s = s[(s[:, 6] != 0) & (s[:, 5] != 0)]   # the warps that ran a walker
                if rep == 0:                 # a warm-up launch
                    continue
                n_warps = len(s)
                d = np.diff(s[:, [0, 1, 2, 3, 4, 5]], axis=1)
                ran = s[:, 3] != 0   # the walkers inside the priors: points evaluated
                for k, ph in enumerate(PHASES):
                    dk = d[ran, k] if ph in ("points", "butterfly") else d[:, k]
                    per_launch[ph].append((np.median(dk), dk.max()))
                per_launch["entry_spread_ns"].append(float(s[:, 6].max() - s[:, 6].min()))
                per_launch["warp_ns"].append((np.median(s[:, 7] - s[:, 6]),
                                              float((s[:, 7] - s[:, 6]).max())))
                per_launch["cycles_per_ns"].append(float(np.median(
                    (s[:, 9] - s[:, 0]) / np.maximum(s[:, 7] - s[:, 6], 1))))
            x, lg = x0.clone(), l0.clone()
            dev_ms = device_ms(lambda: sc.half_step_launch(
                prefix, lp, x, lg, 0, u_z, j, u_acc, 2.0, off, scale, n_accept=acc,
                check_partners=False, **fkw), "stretch_half_step_kernel", args.launches, 5)
            xo = state(half, half, outside=True)
            lo_ = torch.full((2, half), -np.inf, dtype=torch.float64, device=dev)
            none_ms = device_ms(lambda: sc.half_step_launch(
                prefix, lp, xo, lo_, 0, u_z, j, u_acc, 2.0, off, scale, n_accept=acc,
                check_partners=False, **fkw), "stretch_half_step_kernel", args.launches, 5)
            row = {ph: [float(np.median([v[0] for v in per_launch[ph]])),
                        float(np.median([v[1] for v in per_launch[ph]]))] for ph in PHASES}
            cpn = float(np.median(per_launch["cycles_per_ns"]))
            row.update(warps=n_warps, cycles_per_ns=cpn,
                       entry_spread_us=float(np.median(per_launch["entry_spread_ns"])) / 1e3,
                       warp_us=[float(np.median([v[0] for v in per_launch["warp_ns"]])) / 1e3,
                                float(np.median([v[1] for v in per_launch["warp_ns"]])) / 1e3],
                       device_ms=dev_ms, no_likelihood_device_ms=none_ms)
            out[f"{prefix}_half_{half}"] = row
            lines.append(
                f"{name} half {half} (stamped warp form, {n_warps} warps, {cpn:.3f} cycles/ns): "
                + ", ".join(f"{ph} {row[ph][0]:.0f} cycles median ({row[ph][0] / cpn / 1e3:.2f}"
                            f" us), {row[ph][1]:.0f} largest" for ph in PHASES)
                + f"; a warp entry to exit {row['warp_us'][0]:.2f} us median, "
                f"{row['warp_us'][1]:.2f} largest; blocks' entries spread over "
                f"{row['entry_spread_us']:.2f} us; device {min(dev_ms):.4f} ms (stamped); "
                f"without the likelihood {min(none_ms):.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    out["card"], out["ptxas"] = smi, ptxas
    for line in lines:
        print(f"[probe_sc_latency] {args.label} {line}", flush=True)
    for k, v in ptxas.items():   # the half-steps' float32 instantiations (all in the JSON)
        if "half_step" in k and "IfLi0E" in k:
            print(f"[probe_sc_latency] {args.label} ptxas {k}: registers {v[0]}, stack frame "
                  f"{v[1]} bytes, spills {v[2] + v[3]}", flush=True)
    print(f"[probe_sc_latency] {args.label} nvidia-smi: {smi}", flush=True)
    print(json.dumps(out), flush=True)
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
