#!/usr/bin/env python3
"""Where the time of the population kernels P2 (one half-step of all S
ensembles) and P3 (the MAP seeding's whole Adam ascent) goes, on one CUDA
card, from ``clock64()`` stamps in a copy of one checkout's package.

* P2's warp form (``stretch_half_step_kernel<PopSC2WarpModel>``: a warp per
  walker): the phases of a walker, as ``tools/probe_sc_latency.py`` stamps
  them (its anchors in ``csrc/stretch.cuh``): the block's staging of its
  transient's rows, the walker's prologue (proposal, prior, constants), the
  lanes' point loop, the butterfly and the finish, the accept and its
  writes. P2's latency form, where the checkout has one, is timed beside it.
* P3 (``pop_map_kernel``): for each start, the cycles of each phase summed
  over its evaluations, then divided by their number: the bounds bijection
  (``adam_bounded``), the prior and the walker's constants, the points, the
  reduction of the sums over the lanes (and, where a start spans two warps,
  over the warps), the finish and the gradient's assembly, the Adam step;
  and the block's staging once.

A checkout whose ``csrc/population.cu`` has the hooks ``POP_MAP_MARK(k)``
(no-ops unless ``POP_MAP_PROBE`` is defined) is stamped through them; an
older one (a block per transient, a warp per start) through anchors in its
source. Lane 0 of every warp records after a ``__syncwarp()``, so a phase
is the warp's. Printed: each phase's median and largest cycles over the
warps, the cycles per nanosecond (clock64 against ``%globaltimer`` between
a warp's entry and exit), and each kernel's device time by the profiler
(the stamps included). Inputs: examples/fit_population.py's population
(``chip_smoke.pop_example``), float32 compute, 64 walkers and 16 starts x
400 steps a transient, at S = 64 and 512 (``--sizes``).

Usage: ``python3 tools/probe_pop_latency.py [--repo PATH] [--label NAME]``.
The last line is one JSON object with the card and every number printed.
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

TOOLS = os.path.dirname(os.path.abspath(__file__))
STAMP_WARPS = 65536          # P2 at S = 512: 16384 walkers in a warp each
SLOTS = 10                   # probe_sc_latency's layout of a warp's slots
P2_PHASES = ("staging", "prologue", "points", "butterfly", "accept")
P3_PHASES = ("bijection", "prior", "points", "reduce", "finish", "adam")
P3_SLOTS = 10                # the six phases, the evaluations, staging, entry and exit times
P3_WARPS = 16384             # S = 512 x 16 starts x 2 warps

# probe_sc_latency's stamps, the warp counted over blockIdx.y too (the
# ensembles of P2)
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
    const int lcf_w = (blockIdx.y * gridDim.x + blockIdx.x) * (blockDim.x >> 5) \
                      + (threadIdx.x >> 5); \
    if ((threadIdx.x & 31) == 0 && lcf_w < LCF_STAMP_WARPS) \
        lcf_stamps[lcf_w * LCF_STAMP_SLOTS + (k)] = (v); } while (0)
#define LCF_CLOCK(k) do { __syncwarp(); LCF_PUT(k, clock64()); } while (0)
""" % (STAMP_WARPS, SLOTS)

# P3's stamps: a start's phase cycles in registers (lcf_p3[0..5]; [6] the
# evaluations; [7] the last clock), written by its warp's lane 0 at its end
P3_DEFS = r"""
#define POP_MAP_PROBE 1
#define LCF_P3_WARPS %d
#define LCF_P3_SLOTS %d
static __device__ long long lcf_p3[LCF_P3_WARPS * LCF_P3_SLOTS];
#define POP_MAP_PROBE_DECL long long lcf_t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define POP_MAP_MARK(k) do { __syncwarp(); const long long lcf_now = clock64(); \
    lcf_t[k] += lcf_now - lcf_t[7]; lcf_t[7] = lcf_now; if ((k) == 0) lcf_t[6] += 1; } while (0)
#define POP_MAP_START() do { __syncwarp(); lcf_t[7] = clock64(); } while (0)
#define POP_MAP_BEGIN const long long lcf_g0 = lcf_globaltimer(), lcf_c0 = clock64();
#define POP_MAP_STAGED const long long lcf_staging = clock64() - lcf_c0;
#define POP_MAP_PUT(w) do { \
    if ((threadIdx.x & 31) == 0 && (w) < LCF_P3_WARPS) { \
        for (int lcf_k = 0; lcf_k < 7; ++lcf_k) lcf_p3[(w) * LCF_P3_SLOTS + lcf_k] = lcf_t[lcf_k]; \
        lcf_p3[(w) * LCF_P3_SLOTS + 7] = lcf_staging; \
        lcf_p3[(w) * LCF_P3_SLOTS + 8] = lcf_g0; \
        lcf_p3[(w) * LCF_P3_SLOTS + 9] = lcf_globaltimer(); } } while (0)
""" % (P3_WARPS, P3_SLOTS)

READER = """
extern "C" int pop_probe_stamps(long long* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, lcf_stamps, sizeof(long long) * n);
}
extern "C" int pop_probe_p3(long long* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, lcf_p3, sizeof(long long) * n);
}
extern "C" int pop_probe_clear() {
    void* p = nullptr;
    int rc = (int)cudaGetSymbolAddress(&p, lcf_stamps);
    if (rc) return rc;
    rc = (int)cudaMemset(p, 0, sizeof(lcf_stamps));
    if (rc) return rc;
    rc = (int)cudaGetSymbolAddress(&p, lcf_p3);
    return rc ? rc : (int)cudaMemset(p, 0, sizeof(lcf_p3));
}
"""

# P2's point loop in PopSC2WarpModel (either version of the source)
P2_POINTS = [("""        return pop_finish<C>(warp_sum(acc), use_sigma, d.log_norm);
""", """        LCF_CLOCK(3);
        return pop_finish<C>(warp_sum(acc), use_sigma, d.log_norm);
""")]

# P3 in a checkout without the hooks: a block per transient, a warp per start
P3_OLD = [
    ("""template <typename C, int N>
__device__ double pop_value_and_grad_warp(const double* p, const PopData<C>& d,
                                          const PopParams& P, double* g) {
""", """template <typename C, int N>
__device__ __forceinline__ double pop_value_and_grad_warp(const double* p, const PopData<C>& d,
                                          const PopParams& P, double* g, long long* lcf_t) {
"""),
    ("""    const SC2Walker<C> w = pop_sc2_walker<C>(pop_walker<C>(p, P, N), d, P);
    const int Np = (int)P.n_points, K = (int)P.n_coef;
    const bool use_sigma = P.use_sigma != 0;
    SC2Sums<C> s;
""", """    const SC2Walker<C> w = pop_sc2_walker<C>(pop_walker<C>(p, P, N), d, P);
    POP_MAP_MARK(1);
    const int Np = (int)P.n_points, K = (int)P.n_coef;
    const bool use_sigma = P.use_sigma != 0;
    SC2Sums<C> s;
"""),
    ("""    s.acc = warp_sum(s.acc);
""", """    POP_MAP_MARK(2);
    s.acc = warp_sum(s.acc);
"""),
    ("""    if (use_sigma) s.dsig = warp_sum(s.dsig);
""", """    if (use_sigma) s.dsig = warp_sum(s.dsig);
    POP_MAP_MARK(3);
"""),
    ("""    return lprior + ll;
}
""", """    POP_MAP_MARK(4);
    return lprior + ll;
}
"""),
    ("""    const int e = blockIdx.x;
    const PopData<C> d = pop_stage<C>(P, smem_raw, use_smem, e);
    const int S = (int)Q.n_starts;
""", """    const int e = blockIdx.x;
    POP_MAP_BEGIN
    const PopData<C> d = pop_stage<C>(P, smem_raw, use_smem, e);
    POP_MAP_STAGED
    const int S = (int)Q.n_starts;
"""),
    ("""        for (int t = 0; t < (int)Q.n_iter; ++t) {
            adam_bounded<N>(Q, u, x, f);
            pop_value_and_grad_warp<C, N>(x, d, P, g);
            adam_step<N>(Q, g, f, __ldg(Q.sched + 3 * t), __ldg(Q.sched + 3 * t + 1),
                         __ldg(Q.sched + 3 * t + 2), u, m, v);
        }
        adam_bounded<N>(Q, u, x, f);
        const double neg = -pop_value_and_grad_warp<C, N>(x, d, P, g);
""", """        POP_MAP_PROBE_DECL
        POP_MAP_START();
        for (int t = 0; t < (int)Q.n_iter; ++t) {
            adam_bounded<N>(Q, u, x, f);
            POP_MAP_MARK(0);
            pop_value_and_grad_warp<C, N>(x, d, P, g, lcf_t);
            adam_step<N>(Q, g, f, __ldg(Q.sched + 3 * t), __ldg(Q.sched + 3 * t + 1),
                         __ldg(Q.sched + 3 * t + 2), u, m, v);
            POP_MAP_MARK(5);
        }
        adam_bounded<N>(Q, u, x, f);
        POP_MAP_MARK(0);
        const double neg = -pop_value_and_grad_warp<C, N>(x, d, P, g, lcf_t);
        POP_MAP_PUT((int)(blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)));
"""),
]


def patch(path, patches, head="", tail=""):
    with open(path) as f:
        src = f.read()
    for anchor, new in patches:
        if src.count(anchor) != 1:
            raise SystemExit(f"probe_pop_latency: {os.path.basename(path)} has "
                             f"{src.count(anchor)} copies of the anchor "
                             f"{anchor.strip().splitlines()[0]!r}")
        src = src.replace(anchor, new)
    with open(path, "w") as f:
        f.write(head + src + tail)


def stamped_copy(repo):
    """A copy of repo's package (and a link to its data) with the stamps;
    whether its P3 has the hooks."""
    sys.path.insert(0, TOOLS)
    from probe_sc_latency import STRETCH_PATCHES
    root = tempfile.mkdtemp(prefix="pop_stamps_")
    pkg = os.path.join(root, "lightcurve_fitting_tpu_torch")
    shutil.copytree(os.path.join(repo, "lightcurve_fitting_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    os.symlink(os.path.join(repo, "lightcurve_fitting_tpu"),
               os.path.join(root, "lightcurve_fitting_tpu"))
    csrc = os.path.join(pkg, "kernels", "csrc")
    patch(os.path.join(csrc, "stretch.cuh"),
          [("#define LP_THREADS 128\n", "#define LP_THREADS 128\n" + STAMP_DEFS)]
          + STRETCH_PATCHES[1:])
    pop = os.path.join(csrc, "population.cu")
    with open(pop) as f:
        hooks = "POP_MAP_MARK(" in f.read()
    # the P3 definitions go first: the source defines the hooks as no-ops
    # only where POP_MAP_PROBE is not defined
    patch(pop, P2_POINTS + ([] if hooks else P3_OLD),
          head="#include \"stretch.cuh\"\n" + P3_DEFS, tail=READER)
    return root, hooks


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(TOOLS))
    ap.add_argument("--label", default="")
    ap.add_argument("--sizes", default="64,512")
    ap.add_argument("--launches", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_pop_latency: CUDA is not available; this script runs on the GPU")
    repo = os.path.abspath(args.repo)
    root, hooks = stamped_copy(repo)
    sys.path.insert(0, root)
    sys.path.insert(1, TOOLS)
    sys.path.insert(2, repo)
    from time_port_kernels import device_ms, ptxas_report
    import chip_smoke
    from lightcurve_fitting_tpu_torch.kernels import build
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    from lightcurve_fitting_tpu_torch.parallel.hmc import BoundsTransform
    from lightcurve_fitting_tpu_torch.parallel.population import (PopulationPosterior,
                                                                  pack_population)
    lib = build.library()
    for name in ("pop_probe_stamps", "pop_probe_p3"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    ptxas = {k: v for k, v in ptxas_report(build.build_info()["log"]).items()
             if "PopSC2" in k or "pop_map" in k}
    dev = torch.device("cuda")
    two_forms = "form" in kpop.stretch_half_step.__code__.co_varnames
    warp = {"form": "warp"} if two_forms else {}
    out = {"label": args.label, "repo": repo, "p3_hooks": hooks}
    lines = []
    buf = np.zeros(STAMP_WARPS * SLOTS, dtype=np.int64)
    buf3 = np.zeros(P3_WARPS * P3_SLOTS, dtype=np.int64)
    for S in map(int, args.sizes.split(",")):
        lcs, models, _ = chip_smoke.pop_example(S, dev)
        priors, lo, up = chip_smoke.pop_priors()
        pp = PopulationPosterior(pack_population(models, lcs, False, dev), models[0], priors)
        q, off, sc = chip_smoke.pop_state(pp, lo, up, 64, 0, dev)
        x0 = q.reshape(S, 2, 32, 3).contiguous()
        l0 = kpop.log_posterior(pp, q, off, sc).reshape(S, 2, 32)
        g = torch.Generator(device=dev)
        g.manual_seed(S)
        shape = (S, 2, 32)
        u_z = torch.rand(shape, generator=g, device=dev)
        j = torch.randint(0, 32, shape, generator=g, device=dev)
        u_acc = torch.rand(shape, generator=g, device=dev)
        acc = torch.zeros(shape, dtype=torch.int32, device=dev)

        def p2(x, lg, **fkw):
            kpop.stretch_half_step(pp, x, lg, 0, u_z, j, u_acc, 2.0, off, sc, n_accept=acc,
                                   check_partners=False, **fkw)

        per = {k: [] for k in P2_PHASES + ("warp_ns", "cycles_per_ns")}
        for rep in range(args.launches + 1):
            if lib.pop_probe_clear() != 0:
                raise RuntimeError("pop_probe_clear failed")
            p2(x0.clone(), l0.clone(), **warp)
            torch.cuda.synchronize()
            if lib.pop_probe_stamps(buf.ctypes.data, buf.size) != 0:
                raise RuntimeError("pop_probe_stamps failed")
            s = buf.reshape(STAMP_WARPS, SLOTS)
            s = s[(s[:, 6] != 0) & (s[:, 5] != 0)]
            if rep == 0:
                continue
            d = np.diff(s[:, [0, 1, 2, 3, 4, 5]], axis=1)
            ran = s[:, 3] != 0
            for k, ph in enumerate(P2_PHASES):
                dk = d[ran, k] if ph in ("points", "butterfly") else d[:, k]
                per[ph].append((np.median(dk), dk.max()))
            per["warp_ns"].append((np.median(s[:, 7] - s[:, 6]), float((s[:, 7] - s[:, 6]).max())))
            per["cycles_per_ns"].append(float(np.median((s[:, 9] - s[:, 0])
                                                        / np.maximum(s[:, 7] - s[:, 6], 1))))
        cpn = float(np.median(per["cycles_per_ns"]))
        row = {ph: [float(np.median([v[0] for v in per[ph]])),
                    float(np.median([v[1] for v in per[ph]]))] for ph in P2_PHASES}
        x, lg = x0.clone(), l0.clone()
        row.update(warps=int(len(s)), cycles_per_ns=cpn,
                   warp_us=[float(np.median([v[0] for v in per["warp_ns"]])) / 1e3,
                            float(np.median([v[1] for v in per["warp_ns"]])) / 1e3],
                   device_ms=device_ms(lambda: p2(x, lg, **warp), "stretch_half_step",
                                       args.launches, 3))
        if two_forms:
            row["latency_device_ms"] = device_ms(lambda: p2(x, lg, form="latency"),
                                                 "stretch_half_step", args.launches, 3)
        out[f"P2_S{S}"] = row
        lines.append(
            f"P2 S = {S} (stamped warp form, {row['warps']} warps, {cpn:.3f} cycles/ns): "
            + ", ".join(f"{ph} {row[ph][0]:.0f} cycles median ({row[ph][0] / cpn / 1e3:.2f} us),"
                        f" {row[ph][1]:.0f} largest" for ph in P2_PHASES)
            + f"; a warp entry to exit {row['warp_us'][0]:.2f} us median, "
            f"{row['warp_us'][1]:.2f} largest; device {min(row['device_ms']):.4f} ms (stamped)"
            + (f"; the latency form {min(row['latency_device_ms']):.4f} ms (unstamped)"
               if two_forms else ""))

        bounds = BoundsTransform([p.p_min for p in priors], [p.p_max for p in priors])
        x_st = np.random.default_rng(S).uniform(lo, up, size=(S, 16, 3))
        u0 = torch.as_tensor(bounds.to_unbounded(x_st), device=dev).contiguous()
        rows = []
        for rep in range(3):
            if lib.pop_probe_clear() != 0:
                raise RuntimeError("pop_probe_clear failed")
            kpop.map_ascent(pp, u0, bounds, 400)
            torch.cuda.synchronize()
            if lib.pop_probe_p3(buf3.ctypes.data, buf3.size) != 0:
                raise RuntimeError("pop_probe_p3 failed")
            s3 = buf3.reshape(P3_WARPS, P3_SLOTS)
            rows.append(s3[s3[:, 6] != 0].copy())
        s3 = rows[-1]
        evals = s3[:, 6].astype(float)
        ns = (s3[:, 9] - s3[:, 8]).astype(float)
        cyc = s3[:, :6].sum(axis=1) + s3[:, 7]
        cpn3 = float(np.median(cyc / np.maximum(ns, 1)))
        per_eval = {ph: s3[:, k] / evals for k, ph in enumerate(P3_PHASES)}
        r3 = {ph: [float(np.median(v)), float(v.max())] for ph, v in per_eval.items()}
        r3.update(warps=int(len(s3)), evaluations=float(np.median(evals)), cycles_per_ns=cpn3,
                  staging=[float(np.median(s3[:, 7])), float(s3[:, 7].max())],
                  eval_cycles=[float(np.median(sum(per_eval.values()))),
                               float(np.max(sum(per_eval.values())))],
                  warp_us=[float(np.median(ns)) / 1e3, float(ns.max()) / 1e3],
                  device_ms=device_ms(lambda: kpop.map_ascent(pp, u0, bounds, 400),
                                      "pop_map", 1, 3))
        out[f"P3_S{S}"] = r3
        lines.append(
            f"P3 S = {S} (stamped, {r3['warps']} warps, {r3['evaluations']:.0f} evaluations, "
            f"{cpn3:.3f} cycles/ns): an evaluation {r3['eval_cycles'][0]:.0f} cycles median ("
            f"{r3['eval_cycles'][0] / cpn3 / 1e3:.2f} us), {r3['eval_cycles'][1]:.0f} largest: "
            + ", ".join(f"{ph} {r3[ph][0]:.0f} median ({r3[ph][0] / cpn3 / 1e3:.3f} us), "
                        f"{r3[ph][1]:.0f} largest" for ph in P3_PHASES)
            + f"; staging {r3['staging'][0]:.0f} cycles; a warp entry to exit "
            f"{r3['warp_us'][0]:.1f} us median, {r3['warp_us'][1]:.1f} largest; device "
            f"{min(r3['device_ms']):.4f} ms (stamped)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    out["card"], out["ptxas"] = smi, ptxas
    for line in lines:
        print(f"[probe_pop_latency] {args.label} {line}", flush=True)
    for k, v in ptxas.items():
        print(f"[probe_pop_latency] {args.label} ptxas {k}: registers {v[0]}, stack frame "
              f"{v[1]} bytes, spills {v[2] + v[3]}", flush=True)
    print(f"[probe_pop_latency] {args.label} nvidia-smi: {smi}", flush=True)
    print(json.dumps(out), flush=True)
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
