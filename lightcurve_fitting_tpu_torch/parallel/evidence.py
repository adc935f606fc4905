"""Bayesian evidence (marginal likelihood) by stepping-stone sampling, the
port of ``lightcurve_fitting_tpu/parallel/evidence.py``.

The stepping-stone estimator (Xie et al. 2011) computes

    log Z = sum_k log E_{p_k}[ L^(b_{k+1} - b_k) ],
    p_k(theta) ∝ pi(theta) L(theta)^(b_k)

from samples of a ladder of power posteriors. The K+1 tempered ensembles
differ only by the scalar beta in their acceptance ratio, so they run
together: on CUDA each half-step of the whole ladder is one launch of K6a
(the model's tempered half-step kernel) and each step's replica exchange
one launch of K6c, which also writes the step's production outputs (the
post-swap log L of every rung and, for parallel tempering, the cold rung's
states) into device buffers. Burn-in and production never synchronize with
the host inside the loop; the stepping-stone reduction K6d reads the
production log L where it lies, and only the (blocks, K) terms come to the
host. On the CPU the same calls run the kernels' plain versions
(:mod:`~lightcurve_fitting_tpu_torch.kernels.ladder`).

The draws of global step i (u_z, j, u_acc and the swap uniforms, each
(K+1, 2, half), one slice per rung) come from a ``torch.Generator`` on the
device seeded from (seed, i) alone, as in the ensemble sampler. They differ
from the JAX package's keys, so the two agree in distribution; fed the same
draws, one step agrees exactly (``_make_tempered_step``).

The ladder uses the standard quantiles of Beta(0.3, 1) (beta_k = (k/K)^(1/0.3)),
which concentrates rungs near beta = 0 where the integrand varies fastest.

The JAX package caches its compiled ladder kernels across calls
(``_LADDER_CACHE``, ``_TERMS_CACHE``, ``fns_key``) to avoid re-tracing; the
port builds its kernels once per process, so it has no such cache.
"""

import numpy as np
import torch

from ..kernels import ladder
from .sampler import _step_seed, _torch_dtype

__all__ = ["stepping_stone_evidence", "make_beta_ladder"]


def make_beta_ladder(n_rungs, alpha=0.3):
    """K+1 inverse temperatures 0 = b_0 < ... < b_K = 1, Beta(alpha, 1)
    quantiles (Xie et al. 2011's recommended schedule)."""
    return (np.arange(n_rungs + 1) / n_rungs) ** (1.0 / alpha)


def refuse_unported(mesh=None, checkpoint_every=None, checkpoint_file=None, resume_from=None):
    """The ladder options the port does not have yet raise NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError("a sharded ladder (mesh) is not ported yet "
                                  "(ROADMAP Queue 1 item 17)")
    if checkpoint_every is not None or checkpoint_file is not None or resume_from is not None:
        raise NotImplementedError("checkpoint/resume of the ladder is not ported yet "
                                  "(ROADMAP Queue 1 item 16)")


def _make_tempered_step(log_prior_fn, log_like_fn, half, ndim, betas, a=2.0):
    """One stretch-move step of all K tempered ensembles, plain, over given
    draws (evidence.py:39-125).

    ``log_prior_fn``/``log_like_fn`` map walker states (..., ndim) to (...)
    float64. Returns ``step(carry, draws, parity) -> (carry, (logl, accept,
    swapped, x[-1]))`` with carry (x (K, 2, half, ndim), logpri (K, 2, half),
    logl (K, 2, half)) and draws (u_z, j, u_acc, u_swap), each (K, 2, half)."""
    betas = torch.as_tensor(np.asarray(betas, float))

    def step(carry, draws, parity):
        x, logpri, logl = carry
        u_z, j, u_acc, u_swap = draws
        b = betas.to(x.device)
        x0, p0, l0, a0 = ladder.tempered_half_update(
            log_prior_fn, log_like_fn, x[:, 0], x[:, 1], logpri[:, 0], logl[:, 0], b,
            u_z[:, 0], j[:, 0], u_acc[:, 0], a)
        x1, p1, l1, a1 = ladder.tempered_half_update(
            log_prior_fn, log_like_fn, x[:, 1], x0, logpri[:, 1], logl[:, 1], b,
            u_z[:, 1], j[:, 1], u_acc[:, 1], a)
        x, logpri, logl, swapped = ladder.replica_swap_update(
            torch.stack([x0, x1], 1), torch.stack([p0, p1], 1), torch.stack([l0, l1], 1), b,
            u_swap, parity)
        # cold-rung states ride along for parallel-tempering posterior use
        return (x, logpri, logl), (logl, torch.stack([a0, a1], 1), swapped, x[-1])

    return step


def _draws(gen, seed, i, shape, dtype, device):
    """(u_z, j, u_acc, u_swap), each ``shape`` (K, 2, half), of global step
    ``i``: a device generator seeded from (seed, i)."""
    gen.manual_seed(_step_seed(seed, i))
    u_z = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    j = torch.randint(0, shape[-1], shape, generator=gen, device=device)
    u_acc = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    u_swap = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return u_z, j, u_acc, u_swap


def _run_tempered_ladder(target, p0, betas_all, nsteps, nsteps_burnin, a=2.0, seed=0,
                         state_dtype=None, need_cold=True, param_offset=None, param_scale=None,
                         device=None):
    """Burn in and sample every rung of ``betas_all`` (typically including
    beta = 1) with replica-exchange swaps after each stretch step, on
    ``device``, keeping every array there (evidence.py:128-441, its
    single-device "fast" branch).

    ``target``: a LogPosterior (CUDA or CPU) or a pair of callables (CPU).
    ``p0`` (nwalkers, ndim) starts every rung, in the walker-state space
    (affine-rescaled when ``param_offset``/``param_scale`` are given) and in
    ``state_dtype`` (default float64).

    Returns (logl_samples (nsteps, K, nwalkers) float64 on the device,
    acceptance (K,), swap_rate (K,), cold_chain (nsteps, nwalkers, ndim)
    numpy in the state space or None): the cold chain is the LAST rung's
    states, the parallel-tempering posterior when betas_all[-1] == 1."""
    p0 = np.asarray(p0, float)
    nwalkers, ndim = p0.shape
    if nwalkers % 2:
        raise ValueError("nwalkers must be even")
    half = nwalkers // 2
    K = len(betas_all)
    sdt = _torch_dtype(state_dtype) or torch.float64
    dev = torch.device(device)
    x = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(p0.reshape(1, 2, half, ndim),
                                                             (K, 2, half, ndim))),
                        device=dev).to(sdt)
    # every rung starts from p0: its values once, written to all K rungs
    logpri, logl = ladder.ladder_init(target, x[:1], param_offset, param_scale, copies=K)
    betas = torch.as_tensor(np.asarray(betas_all, float), device=dev)
    shape = (K, 2, half)
    n_burn = torch.zeros(shape, dtype=torch.int32, device=dev)
    n_accept = torch.zeros_like(n_burn)
    n_swap = torch.zeros_like(n_burn)
    logl_out = torch.empty((nsteps,) + shape, dtype=torch.float64, device=dev)
    cold = torch.empty((nsteps, 2, half, ndim), dtype=sdt, device=dev) if need_cold else None
    gen = torch.Generator(device=dev)
    for i in range(nsteps_burnin + nsteps):
        u_z, j, u_acc, u_swap = _draws(gen, seed, i, shape, sdt, dev)
        s = i - nsteps_burnin
        counts = n_accept if s >= 0 else n_burn
        for h in (0, 1):
            ladder.tempered_half_step(target, x, logpri, logl, betas, h, u_z, j, u_acc, a,
                                      param_offset, param_scale, counts, check_partners=False)
        if s >= 0:
            ladder.replica_swap(x, logpri, logl, betas, u_swap, i % 2 == 1, n_swap, logl_out[s],
                                None if cold is None else cold[s])
        else:
            ladder.replica_swap(x, logpri, logl, betas, u_swap, i % 2 == 1)
    n = max(nsteps, 1) * nwalkers
    acceptance = (n_accept.sum(dim=(1, 2)).to(torch.float64) / n).cpu().numpy()
    swap_rate = (n_swap.sum(dim=(1, 2)).to(torch.float64) / n).cpu().numpy()
    cold_chain = None if cold is None else \
        cold.cpu().numpy().reshape(nsteps, nwalkers, ndim)
    return logl_out.reshape(nsteps, K, nwalkers), acceptance, swap_rate, cold_chain


def _rung_block_terms(logl_samples, dbetas, boundaries):
    """Stepping-stone block terms t[b, k] = log mean exp(dbeta_k * logl_k)
    over production block b, (len(boundaries), K) float64 numpy, reduced
    where ``logl_samples`` (nsteps, K+1, nwalkers) lies: K6d on CUDA, its
    plain version on the CPU (evidence.py:473-503)."""
    ll = torch.as_tensor(logl_samples, dtype=torch.float64)
    db = torch.as_tensor(np.asarray(dbetas, float), device=ll.device)
    return ladder.rung_block_terms(ll.contiguous(), db, boundaries).cpu().numpy()


def _ladder_target(log_prior_fn, log_like_fn, device):
    """(target, device): a LogPosterior of the priors ``log_prior_fn`` and
    the LogLikelihood ``log_like_fn`` on the likelihood's device, or the pair
    of callables on ``device`` (default: CUDA, raising without it), which must be
    the CPU."""
    from ..core.device import resolve_device
    from ..fitting import LogPosterior
    from ..models.base import LogLikelihood
    if isinstance(log_like_fn, LogLikelihood):
        if not isinstance(log_prior_fn, (list, tuple)):
            raise TypeError("with a LogLikelihood, log_prior_fn must be the list of priors")
        dev = log_like_fn.t.device
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"the LogLikelihood lies on {dev}, not {device}")
        return LogPosterior(log_like_fn, log_prior_fn), dev
    dev = resolve_device(device)
    if dev.type != "cpu":
        raise NotImplementedError(
            "on CUDA the ladder runs the fused kernels of a model, which take its priors and "
            "LogLikelihood; other log-probabilities run on the CPU")
    return (log_prior_fn, log_like_fn), dev


def stepping_stone_evidence(log_prior_fn, log_like_fn, p0, n_rungs=32, nsteps=500,
                            nsteps_burnin=500, alpha=0.3, a=2.0, seed=0, return_cold_chain=False,
                            mesh=None, axis_name="walkers", checkpoint_every=None,
                            checkpoint_file=None, resume_from=None, state_dtype=None,
                            param_offset=None, param_scale=None, device=None):
    """log Z and its uncertainty from one tempered-ladder run.

    ``log_prior_fn``/``log_like_fn``: the list of priors and the model's
    :class:`~lightcurve_fitting_tpu_torch.models.base.LogLikelihood`, which
    run through the K6 kernels on CUDA (on the likelihood's device); or two
    torch callables of absolute float64 parameters (W, ndim) -> (W,), which
    run the plain step on the CPU only (``device``; CUDA raises
    NotImplementedError). ``p0``: (nwalkers, ndim) starting positions in the
    walker-state space, drawn from (or near) the prior; every rung starts
    from the same cloud. ``state_dtype`` with ``param_offset``/
    ``param_scale``: the walker state's dtype and its affine map to absolute
    parameters, ``p = offset + scale * q`` (as the ensemble sampler takes
    it).

    Returns (log_z, log_z_err, info) where info carries the ladder, per-rung
    contributions, per-rung stretch acceptance and swap rates — and, with
    ``return_cold_chain``, the beta = 1 rung's production states (in the
    walker-state space) and log-likelihoods. The error is a 4-block split of
    the production chain (block estimates of each rung's term, combined in
    quadrature); fewer than 2 blocks give inf.

    ``mesh`` (ROADMAP Queue 1 item 17) and ``checkpoint_every``/
    ``checkpoint_file``/``resume_from`` (item 16) are not ported yet and
    raise NotImplementedError.
    """
    refuse_unported(mesh, checkpoint_every, checkpoint_file, resume_from)
    target, dev = _ladder_target(log_prior_fn, log_like_fn, device)
    betas_all = make_beta_ladder(n_rungs, alpha)   # includes beta = 1 (cold)
    dbetas = np.diff(betas_all)
    logl_samples, acceptance, swap_rate, cold_chain = _run_tempered_ladder(
        target, p0, betas_all, nsteps, nsteps_burnin, a=a, seed=seed, state_dtype=state_dtype,
        need_cold=return_cold_chain, param_offset=param_offset, param_scale=param_scale,
        device=dev)
    nsteps_out = logl_samples.shape[0]

    # the full-chain terms combine exactly from the block partials:
    # log mean_N exp(w) = log( sum_b n_b exp(t_b) / N )
    n_blocks = min(4, nsteps_out)
    boundaries = tuple((int(ix[0]), int(ix[-1]) + 1)
                       for ix in np.array_split(np.arange(nsteps_out), n_blocks))
    block_terms = _rung_block_terms(logl_samples, dbetas, boundaries)
    sizes = np.array([b1 - b0 for b0, b1 in boundaries], float)
    m = np.max(block_terms, axis=0)
    terms = m + np.log(np.einsum("b,bk->k", sizes, np.exp(block_terms - m)) / sizes.sum())
    log_z = float(terms.sum())

    if n_blocks >= 2:
        log_z_err = float(np.sqrt(np.sum(block_terms.var(axis=0, ddof=1)
                                         / block_terms.shape[0])))
    else:
        log_z_err = float("inf")  # a 1-step chain has no internal error estimate

    info = {"betas": betas_all, "rung_terms": terms, "acceptance": acceptance,
            "swap_rate": swap_rate, "n_rungs": n_rungs, "nsteps": nsteps}
    if return_cold_chain:
        info["cold_chain"] = cold_chain
        info["cold_logl"] = logl_samples[:, -1, :].cpu().numpy()
    return log_z, log_z_err, info
