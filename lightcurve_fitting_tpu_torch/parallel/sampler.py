"""Affine-invariant ensemble MCMC (Goodman & Weare 2010 stretch move), the
port of ``lightcurve_fitting_tpu/parallel/sampler.py``.

Design
------
Walker state is kept as ``(2, half, ndim)``; within a step the two
half-ensembles are updated in sequence (red-black, exactly emcee's
``StretchMove``), and half 1 uses the already-updated half 0 as its partner
pool — so a step is two dependent half-steps. With a
:class:`~lightcurve_fitting_tpu_torch.fitting.LogPosterior` each half-step is
one call of :func:`~lightcurve_fitting_tpu_torch.kernels.stretch_half_step`:
on CUDA one launch of the model's fused half-step kernel (K2 for
ShockCooling2, its SC3 instantiation for ShockCooling3), which writes the
new state into a preallocated device chain in the store dtype and adds to an
int32 accept counter; the step loop never synchronizes with the host, and
the chain comes to the host once per progress segment. On the CPU the same
call runs the plain half-step, which also serves any other log-probability
callable.

The draws of global step i (u_z, j, u_acc for both halves) come from a
``torch.Generator`` on the device seeded from (seed, i) alone, so a run split
into progress segments equals a single run. Chains agree with the JAX package
(and emcee) in distribution, not path: the random streams differ.
"""

import warnings

import numpy as np
import torch

from .. import kernels
from ..core.device import resolve_device
from ..kernels.common import (absolute_params, half_update, propose_stretch,
                              stretch_half_step_plain)

__all__ = ["EnsembleSampler", "make_stretch_kernel", "propose_stretch"]

# auto-downcast chain storage to float32 past this projected history size
_AUTO_STORE_BYTES = 1e9

_MASK64 = (1 << 64) - 1


def _step_seed(seed, i):
    """A 63-bit generator seed for global step ``i`` of a run seeded ``seed``
    (splitmix64 of the pair): streams of neighbouring steps are unrelated."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(i) + 1) & _MASK64
    for shift, mult in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        z = ((z ^ (z >> shift)) * mult) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _torch_dtype(dt):
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dt)]


def make_stretch_kernel(log_prob_fn, half, ndim, a=2.0):
    """The plain stretch move over given draws.

    ``log_prob_fn`` maps walker states (W, ndim) to log-probabilities (W,).
    Returns ``(half_step, step)``: ``half_step(x_move, x_other, logp_move,
    u_z, j, u_acc) -> (x_new, logp_new, accept)`` and ``step(x, logp, draws)
    -> (x, logp, accept)`` over the (2, half, ndim) state, with ``draws =
    (u_z, j, u_acc)`` each shaped (2, half)."""

    def half_step(x_move, x_other, logp_move, u_z, j, u_acc):
        return half_update(log_prob_fn, x_move, x_other, logp_move, u_z, j, u_acc, a)

    def step(x, logp, draws):
        u_z, j, u_acc = draws
        x0, lp0, a0 = half_step(x[0], x[1], logp[0], u_z[0], j[0], u_acc[0])
        x1, lp1, a1 = half_step(x[1], x0, logp[1], u_z[1], j[1], u_acc[1])
        return torch.stack([x0, x1]), torch.stack([lp0, lp1]), torch.stack([a0, a1])

    return half_step, step


class EnsembleSampler:
    """emcee-compatible ensemble sampler.

    Mirrors the emcee API surface the reference uses: ``run_mcmc`` (returning a
    3-tuple whose first element is the walker positions), ``reset``, ``chain``
    (nwalkers, nsteps, ndim), ``flatchain``, ``flatlnprobability``, and
    ``acceptance_fraction``.
    """

    def __init__(self, nwalkers, ndim, log_prob_fn, a=2.0, seed=None, dtype=torch.float64,
                 store_dtype=None, replicas=1, param_offset=None, param_scale=None,
                 device=None):
        """``log_prob_fn`` maps absolute float64 parameters (W, ndim) to (W,)
        log-probabilities. A :class:`~lightcurve_fitting_tpu_torch.fitting.
        LogPosterior` runs through its model's fused kernels on CUDA; any
        other callable runs the plain step, on the CPU only.

        ``store_dtype`` (e.g. np.float32) downcasts the *stored* chain
        history. The default ``None`` is auto: runs whose projected history
        exceeds ~1 GB downcast to float32 with a printed note; pass
        ``np.float64`` to always keep full-precision storage.

        ``param_offset``/``param_scale`` (ndim,): walkers internally hold the
        affine-rescaled state ``q = (p - offset) / scale``; ``log_prob_fn``
        still receives absolute parameters (reconstructed in float64) and
        every public surface (initial_state, chains, returned positions)
        stays absolute. The stretch move is affine-equivariant, so the
        statistics are identical, and O(1) scaled values make
        ``dtype=float32`` walker state safe."""
        from ..fitting import LogPosterior
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        if int(replicas) != 1:
            raise NotImplementedError("replicas > 1 is not ported yet (ROADMAP Queue 1 item 4)")
        self.device = resolve_device(device)
        self._fused = isinstance(log_prob_fn, LogPosterior)
        if self.device.type == "cuda":
            if not self._fused:
                raise NotImplementedError(
                    "on CUDA the sampler runs a fused half-step kernel, which takes a "
                    "LogPosterior (fitting.make_log_posterior); other log-probabilities run "
                    "on the CPU")
            kernels.module_for(log_prob_fn.log_likelihood.model)  # raises without kernels
        self._store_dtype = _torch_dtype(store_dtype)
        if (param_offset is None) != (param_scale is None):
            raise ValueError("param_offset and param_scale must be given together")
        self._offset = None if param_offset is None else np.asarray(param_offset, float)
        self._scale = None if param_scale is None else np.asarray(param_scale, float)
        if self._scale is not None:
            if self._scale.shape != (int(ndim),) or not np.all(self._scale > 0):
                raise ValueError("param_scale must be (ndim,) positive")
        if nwalkers < 2 * ndim + 2:
            # same spirit as emcee's guardrail; keep it a warning not an error
            warnings.warn(f"nwalkers={nwalkers} is small for ndim={ndim}; "
                          "the stretch move needs nwalkers >> ndim")
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.a = float(a)
        self.replicas = 1
        self._half = self.nwalkers // 2
        self._dtype = _torch_dtype(dtype)
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
        self._seed = int(seed)
        self._gen = torch.Generator(device=self.device)
        self._draw_count = 0
        self._log_prob_fn = log_prob_fn
        self.reset()

    @property
    def total_walkers(self):
        """Walkers across all replicas (= nwalkers: one replica)."""
        return self.nwalkers * self.replicas

    @property
    def param_offset(self):
        return self._offset

    @property
    def param_scale(self):
        return self._scale

    # ------------------------------------------------------------------ state
    def reset(self):
        self._chain = np.empty((0, self.total_walkers, self.ndim))  # (nsteps, walkers, ndim)
        self._logp = np.empty((0, self.total_walkers))
        self._accepted = np.zeros(self.total_walkers)
        self._nsteps_total = 0

    def batched_logp(self, q):
        """Log-probability (W,) float64 of walker states ``q`` (W, ndim) in the
        internal (possibly rescaled) space: the fused log-posterior kernel
        for a LogPosterior on CUDA."""
        if self._fused:
            return kernels.log_posterior(self._log_prob_fn, q, self._offset, self._scale)
        return self._log_prob_fn(absolute_params(q, self._offset, self._scale))

    def _draws(self, i):
        """(u_z, j, u_acc), each (2, half), of global step ``i``."""
        g = self._gen
        g.manual_seed(_step_seed(self._seed, i))
        shape = (2, self._half)
        u_z = torch.rand(shape, generator=g, device=self.device, dtype=self._dtype)
        j = torch.randint(0, self._half, shape, generator=g, device=self.device)
        u_acc = torch.rand(shape, generator=g, device=self.device, dtype=self._dtype)
        return u_z, j, u_acc

    def _half_step(self, x, logp, h, u_z, j, u_acc, chain_x, chain_logp, n_accept):
        if self._fused:
            kernels.stretch_half_step(self._log_prob_fn, x, logp, h, u_z, j, u_acc, self.a,
                                      self._offset, self._scale, chain_x, chain_logp, n_accept,
                                      check_partners=False)
        else:
            stretch_half_step_plain(self.batched_logp, x, logp, h, u_z, j, u_acc, self.a,
                                    chain_x, chain_logp, n_accept)

    # -------------------------------------------------------------- main API
    def run_mcmc(self, initial_state, nsteps, progress=False, progress_kwargs=None,
                 skip_initial_state_check=False, thin_by=1, **kwargs):
        """Advance the ensemble ``nsteps`` iterations from ``initial_state``
        (array of shape (nwalkers, ndim), or None to continue).

        With ``progress=True`` the run is split into ~10 equal segments so
        acceptance-rate progress lines appear during long runs; otherwise the
        chain comes to the host once, at the end."""
        if initial_state is None:
            if not hasattr(self, "_pos_internal"):
                raise ValueError("no previous state; provide initial_state")
            x = self._pos_internal
            logp = self._logp_internal
        else:
            pos = np.ascontiguousarray(np.asarray(initial_state, float))
            if pos.shape != (self.total_walkers, self.ndim):
                raise ValueError(f"initial_state must have shape {(self.total_walkers, self.ndim)}")
            if self._offset is not None:
                pos = (pos - self._offset) / self._scale
            x = torch.as_tensor(pos.reshape(2, self._half, self.ndim),
                                device=self.device).to(self._dtype).contiguous()
            logp = self.batched_logp(x.reshape(-1, self.ndim)).reshape(2, self._half)
            if not skip_initial_state_check and not bool(torch.all(torch.isfinite(logp))):
                bad = int(torch.sum(~torch.isfinite(logp)))
                raise ValueError(f"{bad} walkers have non-finite initial log-probability")

        # bound host memory by default: when the projected history passes
        # ~1 GB, store chains as float32 (posterior summaries are unaffected;
        # walker state and proposals keep their dtype). Explicit store_dtype
        # (e.g. np.float64) disables the auto-downcast.
        if self._store_dtype is None:
            projected = (self._chain.nbytes
                         + nsteps * self.total_walkers * (self.ndim + 1) * 8)
            if projected > _AUTO_STORE_BYTES:
                print(f"chain history would be {projected / 1e9:.1f} GB in "
                      "float64; storing chains as float32 (pass "
                      "store_dtype=np.float64 to keep full precision)")
                self._store_dtype = torch.float32

        desc = (progress_kwargs or {}).get("desc", "Sampling").strip()
        if progress and nsteps >= 50:
            seg = max(nsteps // 10, 1)
            segments = [seg] * (nsteps // seg)
            if nsteps % seg:
                segments.append(nsteps % seg)
        else:
            segments = [nsteps]
            if progress:
                print(f"{desc}: {nsteps} steps x {self.total_walkers} walkers "
                      f"(one segment)")

        done = 0
        for seg_steps in segments:
            x, logp = self._run_segment(x, logp, seg_steps, thin_by)
            done += seg_steps
            if progress and len(segments) > 1:
                af = self._accepted.mean() / max(self._nsteps_total, 1)
                print(f"{desc}: {done}/{nsteps} steps (mean acceptance {af:.2f})")

        self._pos_internal = x
        self._logp_internal = logp
        pos = self._absolute(x.cpu().numpy().reshape(self.total_walkers, self.ndim))
        if self._offset is not None and self._dtype == torch.float32:
            # contraction safeguard: warn before the posterior width sinks
            # into f32 quantization of the scaled space
            spread = pos.std(axis=0) / self._scale
            if np.any((spread > 0) & (spread < 32 * np.finfo(np.float32).eps)):
                warnings.warn(
                    "walker spread has contracted below ~32 float32 ulps of "
                    "the rescaled state in at least one dimension; pass "
                    "state_dtype=np.float64 (or a narrower init window) to keep "
                    "resolving the posterior")
        return pos, logp.cpu().numpy().reshape(self.total_walkers), None

    def _run_segment(self, x, logp, nsteps, thin_by):
        """``nsteps`` stored steps of ``thin_by`` proposals each. The state is
        updated in place; the chain and accept counts come to the host once,
        at the end."""
        dev = self.device
        shape = (2, self._half)
        chain_x = torch.empty((nsteps,) + shape + (self.ndim,), device=dev,
                              dtype=self._store_dtype or self._dtype)
        chain_logp = torch.empty((nsteps,) + shape, device=dev,
                                 dtype=self._store_dtype or torch.float64)
        n_accept = torch.zeros(shape, dtype=torch.int32, device=dev)
        n = nsteps * thin_by
        for s in range(n):
            u_z, j, u_acc = self._draws(self._draw_count + s)
            stored = s % thin_by == thin_by - 1
            cx = chain_x[s // thin_by] if stored else None
            cl = chain_logp[s // thin_by] if stored else None
            for h in (0, 1):
                self._half_step(x, logp, h, u_z[h], j[h], u_acc[h], cx, cl, n_accept)
        self._draw_count += n

        chain_block = chain_x.cpu().numpy().reshape(nsteps, self.total_walkers, self.ndim)
        logp_block = chain_logp.cpu().numpy().reshape(nsteps, self.total_walkers)
        if self._store_dtype is not None and self._chain.dtype != chain_block.dtype:
            # keep the accumulated history in the store dtype too — otherwise
            # np.concatenate silently promotes the downcast blocks back to
            # float64 and the host memory bound is lost
            self._chain = self._chain.astype(chain_block.dtype)
            self._logp = self._logp.astype(logp_block.dtype)
        self._chain = np.concatenate([self._chain, chain_block])
        self._logp = np.concatenate([self._logp, logp_block])
        self._accepted += n_accept.cpu().numpy().reshape(self.total_walkers)
        self._nsteps_total += n
        return x, logp

    sample = run_mcmc

    # ------------------------------------------------------------- accessors
    def _absolute(self, c):
        """Internal (possibly rescaled) state -> absolute parameter values.
        The map runs in float64 so a float32 scaled store still resolves
        absolute values to (scale * f32 ulp) precision."""
        if self._offset is None:
            return c
        return np.asarray(c, np.float64) * self._scale + self._offset

    def get_chain(self, flat=False, thin=1, discard=0):
        c = self._absolute(self._chain[discard::thin])
        if flat:
            return c.reshape(-1, self.ndim)
        return c

    def get_log_prob(self, flat=False, thin=1, discard=0):
        lp = self._logp[discard::thin]
        return lp.reshape(-1) if flat else lp

    @property
    def chain(self):
        """(nwalkers, nsteps, ndim), emcee's legacy layout (used by the
        reference's chain-history plots, fitting.py:139)."""
        return np.swapaxes(self._absolute(self._chain), 0, 1)

    @property
    def flatchain(self):
        return self.get_chain(flat=True)

    @property
    def lnprobability(self):
        return np.swapaxes(self._logp, 0, 1)

    @property
    def flatlnprobability(self):
        return self._logp.reshape(-1)

    @property
    def acceptance_fraction(self):
        n = max(self._nsteps_total, 1)
        return self._accepted / n

    def get_autocorr_time(self, **kwargs):
        """Integrated autocorrelation time per parameter (Sokal's adaptive
        windowing, as in emcee.autocorr), one batched real FFT over
        (walker, parameter) columns."""
        return _integrated_autocorr(self._chain)


def _next_pow_two(n):
    i = 1
    while i < n:
        i <<= 1
    return i


def _integrated_autocorr(chain, c=5.0, max_walkers=4096):
    """chain: (nsteps, nwalkers) for one parameter, or (nsteps, nwalkers,
    ndim); returns tau (scalar or (ndim,)). Batched over walkers AND
    parameters in one rfft; per-column normalization matches the per-walker
    1-D estimator exactly (columns with zero variance contribute zeros)."""
    chain = np.asarray(chain, float)
    squeeze = chain.ndim == 2
    if squeeze:
        chain = chain[:, :, None]
    n, w, d = chain.shape
    if w > max_walkers:
        stride = w // max_walkers
        chain = chain[:, ::stride][:, :max_walkers]
    x = chain - chain.mean(axis=0)
    nfft = 2 * _next_pow_two(n)
    f = np.fft.rfft(x, n=nfft, axis=0)
    acf = np.fft.irfft(f * np.conjugate(f), n=nfft, axis=0)[:n].real
    # normalize by the exact sum of squares (acf[0] up to fft roundoff):
    # a zero-variance column is then *exactly* zero, not roundoff garbage
    norm = (x * x).sum(axis=0)                     # (nwalkers, ndim)
    good = norm > 0
    acf = np.where(good, acf / np.where(good, norm, 1.0), 0.0)
    fm = acf.mean(axis=1)                          # (nsteps, ndim)
    taus = 2.0 * np.cumsum(fm, axis=0) - 1.0
    window = np.arange(n)[:, None] >= c * taus
    first = np.argmax(window, axis=0)
    hit = np.any(window, axis=0)
    out = np.where(hit, taus[first, np.arange(taus.shape[1])], taus[-1])
    return out[0] if squeeze else out
