"""Build and load the CUDA kernels of ``kernels/csrc/``.

The sources are compiled with ``nvcc`` into one shared library with a plain C
interface, at first use, and loaded with :mod:`ctypes` (no PyTorch headers:
the build takes seconds, not minutes). Each ``.cu`` compiles in its own
``nvcc`` process, all started together, and one more links the objects.
The library lands in ``kernels/_build/`` (ignored by git) under a name keyed
by a hash of the sources and the flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import: the module imports on
machines without ``nvcc`` or a GPU, and :func:`library` raises there.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["library", "build_info", "NVCC_FLAGS"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
_info = {}


def _nvcc():
    candidates = [os.environ.get("CUDACXX"), shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDACXX or CUDA_HOME): the CUDA kernels of "
                       "lightcurve_fitting_tpu_torch are built from source at first use")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs, headers


def _declare(lib):
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.sc2_logpost_launch.restype = ci
    lib.sc2_logpost_launch.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp]
    lib.stretch_half_step_launch.restype = ci
    half_step = [vp, ci, ci, vp, ci, vp, ci, ci, vp, vp, vp, cd, vp, ci, vp, ci, vp, vp]
    lib.stretch_half_step_launch.argtypes = half_step
    lib.bandflux_launch.restype = ci
    lib.bandflux_launch.argtypes = [vp, ci, ci, ci, vp]
    lib.sc3_logpost_launch.restype = ci
    lib.sc3_logpost_launch.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp]
    lib.sc3_half_step_launch.restype = ci
    lib.sc3_half_step_launch.argtypes = half_step
    lib.epoch_logpost_launch.restype = ci
    lib.epoch_logpost_launch.argtypes = [vp, ci, ci, vp, ci, ci, vp, ci, vp, ci, vp]
    lib.epoch_half_step_launch.restype = ci
    lib.epoch_half_step_launch.argtypes = half_step[:-1] + [ci, ctypes.c_longlong, vp]
    lib.epoch_map_polish_launch.restype = ci
    lib.epoch_map_polish_launch.argtypes = [vp, vp, ci, ci, vp]
    lib.epoch_summary_launch.restype = ci
    lib.epoch_summary_launch.argtypes = [vp, ci, ci, ci, vp]
    lib.percentile_launch.restype = ci
    lib.percentile_launch.argtypes = [vp, ci, vp]
    lib.cs_logpost_launch.restype = ci
    lib.cs_logpost_launch.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp]
    lib.cs_half_step_launch.restype = ci
    lib.cs_half_step_launch.argtypes = half_step
    lib.sed_logpost_launch.restype = ci
    lib.sed_logpost_launch.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp]
    lib.sed_half_step_launch.restype = ci
    lib.sed_half_step_launch.argtypes = half_step
    lib.sed_run_launch.restype = ci
    lib.sed_run_launch.argtypes = [vp, ci, ci, vp, ci, vp, ci, ci, ci, vp, vp, vp, cd, vp, ci, vp,
                                   ci, vp, vp]
    lib.sifto_launch.restype = ci
    lib.sifto_launch.argtypes = [vp, ci, ci, ctypes.POINTER(ci), vp]
    for prefix in ("sc", "sc4"):
        fn = getattr(lib, f"{prefix}_logpost_launch")
        fn.restype = ci
        fn.argtypes = [vp, ci, ci, vp, ci, ci, vp, ci, vp]   # the form before the stream
        fn = getattr(lib, f"{prefix}_half_step_launch")
        fn.restype = ci
        fn.argtypes = half_step[:-1] + [ci, vp]   # the form before the stream
    for prefix in ("sc2", "sc3", "sc", "sc4", "cs"):
        fn = getattr(lib, f"{prefix}_tempered_half_step_launch")
        fn.restype = ci
        fn.argtypes = [vp, ci, ci, vp, ci, vp, vp, vp, ci, ci, ci, vp, vp, vp, cd, vp, vp]
        if prefix in ("sc", "sc4"):
            fn.argtypes = fn.argtypes[:-1] + [ci, vp]   # the form before the stream
        fn = getattr(lib, f"{prefix}_ladder_init_launch")
        fn.restype = ci
        fn.argtypes = [vp, ci, ci, vp, ci, ci, ci, ci, vp, vp, vp]
        if prefix in ("sc", "sc4"):
            fn.argtypes = fn.argtypes[:-1] + [ci, vp]   # the form before the stream
    lib.pop_logpost_launch.restype = ci
    lib.pop_logpost_launch.argtypes = [vp, ci, ci, vp, ci, ci, ci, vp, ci, vp]   # form, stream
    lib.pop_half_step_launch.restype = ci
    # the chain's state in the state's type, its log-posteriors float64: no
    # dtype flags for them; the form before the stream
    lib.pop_half_step_launch.argtypes = [vp, ci, ci, vp, ci, vp, ci, ci, vp, vp, vp, cd, vp, vp,
                                         vp, ci, ctypes.c_longlong, ci, vp]
    # over ShockCooling and ShockCooling4 (csrc/pop_sc.cu), the same arguments
    lib.pop_sc_logpost_launch.restype = ci
    lib.pop_sc_logpost_launch.argtypes = lib.pop_logpost_launch.argtypes
    lib.pop_sc_half_step_launch.restype = ci
    lib.pop_sc_half_step_launch.argtypes = lib.pop_half_step_launch.argtypes
    lib.pop_map_launch.restype = ci
    lib.pop_map_launch.argtypes = [vp, vp, ci, ci, ci, ci, vp]   # the form before the stream
    lib.replica_swap_launch.restype = ci
    lib.replica_swap_launch.argtypes = [ci, vp, ci, ci, vp, vp, vp, ci, ci, vp, ci, vp, vp, vp,
                                        vp]
    lib.rung_block_terms_launch.restype = ci
    lib.rung_block_terms_launch.argtypes = [ci, vp, ci, ci, vp, ci, ci, vp, vp, ci, ci, vp, vp,
                                            vp, vp]
    lib.sc2_logpost_grad_launch.restype = ci
    lib.sc2_logpost_grad_launch.argtypes = [vp, ci, ci, vp, vp, ci, vp, vp, ci, vp, vp]
    lib.sc2_nuts_transition_launch.restype = ci
    lib.sc2_nuts_transition_launch.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                               vp, vp, vp, vp, vp, vp, vp]
    lib.sc2_block_scratch_len.restype = ctypes.c_longlong
    lib.sc2_block_scratch_len.argtypes = [vp, ci, ci, ci, ci]
    lib.sc2_hmc_transition_launch.restype = ci
    lib.sc2_hmc_transition_launch.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                                              vp, vp, vp, vp, vp]
    return lib


def _run(cmds):
    """Run the commands together; returns their combined output, or raises
    with the first failure's."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    logs = []
    failed = None
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def _compile(srcs, out):
    """nvcc each source to an object, in parallel, then link ``out``."""
    nvcc = _nvcc()
    objs = [f"{out}.{os.path.basename(src)}.o" for src in srcs]
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(srcs, objs)])
        log += _run([[nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", out,
                      *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return log


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs, headers = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in srcs + headers:
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode())
                h.update(f.read())
        out = os.path.join(BUILD_DIR, f"liblcft_kernels_{h.hexdigest()[:16]}.so")
        t0 = time.perf_counter()
        log = ""
        built = False
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            log = _compile(srcs, tmp)
            with open(f"{out}.log", "w") as f:   # kept for a run that reuses the library
                f.write(log)
            os.replace(tmp, out)
            built = True
        elif os.path.exists(f"{out}.log"):
            with open(f"{out}.log") as f:
                log = f.read()
        _lib = _declare(ctypes.CDLL(out))
        _info.update(path=out, built=built, seconds=time.perf_counter() - t0, log=log)
        return _lib


def build_info():
    """Where the library came from: path, whether this process built it, the
    seconds it took, and nvcc's output (register, stack and shared-memory
    use), also when the library was reused."""
    return dict(_info)
