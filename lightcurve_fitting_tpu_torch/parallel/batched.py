"""Batched per-epoch blackbody fits: every epoch's SED fit runs concurrently
(the port of ``lightcurve_fitting_tpu/parallel/batched.py``).

Epochs are padded to the widest band count with masks (:func:`pack_epochs`),
and E independent stretch-move ensembles advance in lockstep: on CUDA one
half-step kernel launch moves every epoch's half-ensemble
(``kernels/csrc/epoch_bb.cu``). :class:`EpochPosterior` holds the packed
epochs in the compute dtype and evaluates the per-epoch log-posterior:
through K4 on CUDA, through its plain version :meth:`EpochPosterior.plain`
on the CPU. :func:`batched_map_centers` scores a log-uniform cloud and
polishes the best starts with Adam, every epoch's whole polish in one
launch (K4p);
:func:`batched_blackbody_mcmc` samples and, with ``summaries``, reduces each
epoch's chain to its percentiles on the device (K4s, then K5).

Draws come from a ``torch.Generator`` on the device seeded by
splitmix64(seed, step) (:func:`..parallel.sampler._step_seed`), so results
agree with the JAX package in distribution, not path.
"""

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels import epoch_bb
from ..models.base import intrinsic_scatter_units
from ..models.blackbody import planck_lnu
from ..ops.filterbank import native_lengths
from ..ops.quantile import percentile_f32
from .hmc import BoundsTransform
from .sampler import _step_seed

__all__ = ["pack_epochs", "EpochPosterior", "batched_blackbody_mcmc", "batched_map_centers"]

SUMMARY_PERCENTILES = (16.0, 50.0, 84.0)


def _no_mesh(mesh):
    if mesh is not None and mesh is not False:
        raise NotImplementedError("sharding the epochs over a device mesh is not ported yet "
                                  "(ROADMAP Queue 1 item 17)")


def pack_epochs(epochs, bank, z=0.0, device=None):
    """Pad a list of single-epoch LC tables into dense tensors on ``device``
    (default: CUDA when present).

    Returns dict with y (E, B), dy (E, B), mask (E, B) [True = real band],
    nodes (E, B, K), weights (E, B, K) float64, and yscale (E,), the median
    of each epoch's nonzero |y|; padded bands get zero weights and mask
    False, so they contribute nothing to the likelihood. Built in host
    numpy, bit-equal to the JAX function's arrays.
    """
    E = len(epochs)
    B = max(len(e) for e in epochs)
    K = bank.n_nodes
    y = np.zeros((E, B))
    dy = np.ones((E, B))
    mask = np.zeros((E, B), bool)
    nodes = np.ones((E, B, K))
    weights = np.zeros((E, B, K))
    emitted = bank.emitted_nodes(z)
    for e, ep in enumerate(epochs):
        ids = bank.band_ids(list(ep["filter"]))
        nb = len(ids)
        y[e, :nb] = np.asarray(ep["lum"], float)
        dy[e, :nb] = np.asarray(ep["dlum"], float)
        mask[e, :nb] = True
        nodes[e, :nb] = emitted[ids]
        weights[e, :nb] = bank.weights[ids]
        nodes[e, nb:] = emitted[ids[0] if nb else 0][-1]
    yscale = np.array([np.median(np.abs(yy[np.abs(yy) > 0])) if np.any(yy != 0) else 1.0
                       for yy in y])
    dev = resolve_device(device)
    return {name: torch.as_tensor(a, device=dev) for name, a in
            (("y", y), ("dy", dy), ("mask", mask), ("nodes", nodes), ("weights", weights),
             ("yscale", yscale))}


class EpochPosterior:
    """The per-epoch blackbody log-posterior of packed epochs (the JAX
    package's ``_make_epoch_logpost``, batched over epochs): ``p`` (E, M,
    ndim) absolute parameters (T, R[, ..., sigma]) -> (E, M) float64.

    Data are normalized to O(1) per epoch by ``yscale``; the dropped
    constant only shifts each epoch's posterior. The buffers, on the packed
    tensors' device: ``y``, ``dy``, ``inv_dy`` (0 on padding bands),
    ``sigma_units`` (E, B), ``nodes``, ``weights`` (E, B, K) and
    ``inv_yscale`` (E,) in the compute dtype (float32 on CUDA by default);
    ``log_norm`` (E,) float64; ``mask`` (E, B) bool; ``n_native`` (E, B)
    int64, each band's node count before its zero-weight padding."""

    def __init__(self, packed, priors, cutoff_freq=np.inf, use_sigma=False,
                 sigma_type="relative"):
        from ..core import config
        dev = packed["y"].device
        dt = config.get_compute_dtype(dev)
        self.compute_dtype = dt if dt is not None else torch.float64
        cdt = self.compute_dtype
        self.priors = list(priors)
        self.cutoff_freq = cutoff_freq
        self.use_sigma = bool(use_sigma)
        y = packed["y"].cpu().numpy()
        dy = packed["dy"].cpu().numpy()
        mask = packed["mask"].cpu().numpy()
        inv_yscale = 1.0 / packed["yscale"].cpu().numpy()
        y_s = y * inv_yscale[:, None]
        dy_s = dy * inv_yscale[:, None]
        units = np.stack([np.broadcast_to(intrinsic_scatter_units(dy_s[e], sigma_type,
                                                                  mask=mask[e]), dy_s[e].shape)
                          for e in range(len(dy_s))])
        log_norm = -0.5 * np.sum(np.where(mask, np.log(2 * np.pi * dy_s ** 2.0), 0.0), axis=-1)

        def buf(a, dtype=cdt):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

        self.mask = packed["mask"].to(torch.bool).contiguous()
        self.y = buf(y_s)
        self.dy = buf(dy_s)
        self.inv_dy = torch.where(self.mask, 1.0 / self.dy, torch.zeros_like(self.dy))
        self.sigma_units = buf(units)
        self.nodes = packed["nodes"].to(cdt).contiguous()
        self.weights = packed["weights"].to(cdt).contiguous()
        self.inv_yscale = buf(inv_yscale)
        self.log_norm = buf(log_norm, torch.float64)
        self.n_native = torch.as_tensor(native_lengths(packed["weights"].cpu().numpy()),
                                        dtype=torch.int64, device=dev)

    @property
    def n_epochs(self):
        return self.y.shape[0]

    @property
    def device(self):
        return self.y.device

    def plain(self, p):
        """Plain PyTorch log-posterior (the plain version of K4), in the
        JAX accelerator path's dtype order: the Planck sum and the residuals
        in the compute dtype, the priors, ``log_norm`` and the guards in
        float64. Differentiable by autograd."""
        p = p.to(torch.float64)
        cdt = self.compute_dtype
        log_prior = torch.zeros(p.shape[:-1], dtype=torch.float64, device=p.device)
        for i, prior in enumerate(self.priors):
            log_prior = log_prior + prior(p[..., i])
        T = p[..., 0].to(cdt)[..., None, None]                       # (E, M, 1, 1)
        R = p[..., 1].to(cdt)[..., None, None]
        lnu = planck_lnu(self.nodes[:, None], T, R, self.cutoff_freq)  # (E, M, B, K)
        y_fit = torch.sum(self.weights[:, None] * lnu, dim=-1) * self.inv_yscale[:, None, None]
        mask = self.mask[:, None]
        if self.use_sigma:
            sig = p[..., -1].to(cdt)[..., None]
            sigma2 = self.dy[:, None] ** 2.0 + (sig * self.sigma_units[:, None]) ** 2.0
            terms = torch.log(2 * np.pi * sigma2) + (self.y[:, None] - y_fit) ** 2.0 / sigma2
            ll = -0.5 * torch.sum(torch.where(mask, terms, torch.zeros_like(terms)), dim=-1)
        else:
            r = (self.y[:, None] - y_fit) * self.inv_dy[:, None]
            ll = (-0.5 * torch.sum(r * r, dim=-1)).to(torch.float64) + self.log_norm[:, None]
        ll = torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))
        return torch.where(torch.isfinite(log_prior), log_prior + ll.to(torch.float64),
                           torch.full_like(log_prior, -torch.inf))

    def term_scales(self, p):
        """The yardsticks of a K4 check against :meth:`plain` at ``p`` (E,
        M, ndim): (E, M) for the log-posterior and (E, M, ndim) for its
        gradient, float64. The log-posterior sums pieces that cancel near an
        optimum (the residual sum and ``log_norm``; with intrinsic scatter
        the per-band log(2 pi sigma^2) and res^2 / sigma^2), and the
        compute dtype's rounding follows the pieces, not their sum. So the
        log-posterior's scale is |lp - c| + |c| (c = ``log_norm``) without
        intrinsic scatter and |log prior| + 0.5 sum_b (|log(2 pi sigma_b^2)|
        + res_b^2 / sigma_b^2) with it; the gradient's is the sum over the
        real bands of |d piece / dp| for each piece, in the plain
        arithmetic."""
        p = p.detach().to(torch.float64).requires_grad_(True)
        cdt = self.compute_dtype
        T, R = (p[..., k].to(cdt)[..., None, None] for k in (0, 1))
        y_fit = torch.sum(self.weights[:, None] * planck_lnu(self.nodes[:, None], T, R,
                                                             self.cutoff_freq), dim=-1) \
            * self.inv_yscale[:, None, None]                          # (E, M, B)
        mask = self.mask[:, None]
        if self.use_sigma:
            sig = p[..., -1].to(cdt)[..., None]
            sigma2 = self.dy[:, None] ** 2.0 + (sig * self.sigma_units[:, None]) ** 2.0
            pieces = [-0.5 * torch.log(2 * np.pi * sigma2),
                      -0.5 * (self.y[:, None] - y_fit) ** 2.0 / sigma2]
        else:
            pieces = [-0.5 * ((self.y[:, None] - y_fit) * self.inv_dy[:, None]) ** 2.0]
        pieces = [torch.where(mask, t, torch.zeros_like(t)) for t in pieces]
        grad_scale = torch.zeros_like(p)
        for t in pieces:
            for b in range(t.shape[-1]):
                g, = torch.autograd.grad(t[..., b].sum(), p, retain_graph=True)
                grad_scale += g.abs()
        with torch.no_grad():
            lp = self.plain(p)
            if self.use_sigma:
                log_prior = sum(prior(p[..., i]) for i, prior in enumerate(self.priors))
                ll_scale = log_prior.abs() + sum(t.abs().sum(dim=-1) for t in pieces).double()
            else:
                c = self.log_norm[:, None]
                ll_scale = (lp - c).abs() + c.abs()
        return ll_scale, grad_scale

    def __call__(self, p):
        """The log-posterior (E, M) float64 at ``p`` (E, M, ndim): K4 on
        CUDA, the plain version on the CPU."""
        return epoch_bb.log_posterior(self, p.contiguous())[0]

    def differentiable(self, p):
        """The log-posterior at float64 ``p`` as a function autograd can
        differentiate: K4 with its analytic gradient on CUDA
        (:class:`~lightcurve_fitting_tpu_torch.kernels.epoch_bb.EpochLogPosterior`),
        the plain version on the CPU."""
        if p.device.type == "cpu":
            return self.plain(p)
        return epoch_bb.EpochLogPosterior.apply(p, self)


def _generator(device, seed, step):
    g = torch.Generator(device=device)
    g.manual_seed(_step_seed(seed, step))
    return g


def _state_dtype(state_dtype, device):
    if state_dtype == "auto":
        return torch.float32 if device.type == "cuda" else torch.float64
    return torch.float32 if np.dtype(state_dtype) == np.float32 else torch.float64


def _epoch_summary(chain, dt, nu_emit, trap_w, cutoff_freq):
    """(16, 50, 84)th percentiles of T, R, R^2 T^4 and the c2/1e12-scaled
    pseudobolometric integral for each epoch's production samples ``chain``
    (steps, E, nwalkers, ndim): (E, 4, 3) float64, the on-device form of
    ``bolometric._mcmc_record``. The sample rows come from K4s; float32 rows
    (compute dtype float32) take the counting-bisection percentiles (K5 on
    CUDA), float64 rows ``torch.quantile``."""
    rows = epoch_bb.summary_samples(chain, nu_emit, trap_w, cutoff_freq, dt)   # (E, 4, S)
    E = rows.shape[0]
    pct = percentile_f32(rows.reshape(E * 4, -1), list(SUMMARY_PERCENTILES), axis=1)
    return pct.to(torch.float64).T.reshape(E, 4, len(SUMMARY_PERCENTILES))


def _run_ensembles(ep, x, burnin_steps, steps, draws, a=2.0, summaries=None,
                   return_chains=True):
    """The batched stretch-move run from walker state ``x`` (E, 2, half,
    ndim) in the state dtype, with the draws of step i from ``draws(i)``:
    (u_z, j, u_acc), each (E, 2, half). Returns what
    :func:`batched_blackbody_mcmc` returns."""
    E, _, half, ndim = x.shape
    nwalkers = 2 * half
    dev = x.device
    x = x.contiguous()
    logp = ep(x.reshape(E, nwalkers, ndim)).reshape(E, 2, half).contiguous()
    chain_x = torch.empty((steps, E, 2, half, ndim), dtype=x.dtype, device=dev)
    chain_lp = torch.empty((steps, E, 2, half), dtype=x.dtype, device=dev)
    n_accept = torch.zeros((E, 2, half), dtype=torch.int32, device=dev)
    for i in range(burnin_steps + steps):
        if i == burnin_steps:
            n_accept.zero_()   # the acceptance counts production steps only
        u_z, j, u_acc = draws(i)
        slot = i - burnin_steps
        cx = chain_x[slot] if slot >= 0 else None
        cl = chain_lp[slot] if slot >= 0 else None
        for h in (0, 1):
            epoch_bb.stretch_half_step(ep, x, logp, h, u_z, j, u_acc, a, cx, cl, n_accept,
                                       check_partners=False)
    acc = (n_accept.to(torch.float64).sum(dim=(1, 2)) / (nwalkers * steps)).cpu().numpy()
    chains = None
    if return_chains or summaries is None:
        chains = (chain_x.permute(1, 0, 2, 3, 4).reshape(E, steps * nwalkers, ndim)
                  .cpu().numpy().astype(np.float64))
    if summaries is None:
        return chains, acc
    nu_host = (np.asarray(summaries["pseudo_nu"], float)
               * (1.0 + float(summaries.get("z", 0.0))))
    trap_w = np.ones(nu_host.shape)
    trap_w[0] = trap_w[-1] = 0.5
    dt = ep.compute_dtype if ep.compute_dtype != torch.float64 else None
    summ = _epoch_summary(chain_x.reshape(steps, E, nwalkers, ndim), dt,
                          torch.as_tensor(nu_host, device=dev),
                          torch.as_tensor(trap_w, device=dev), ep.cutoff_freq)
    return chains, acc, summ.cpu().numpy()


def batched_blackbody_mcmc(packed, priors, starting_guesses, nwalkers, burnin_steps,
                           steps, cutoff_freq=np.inf, use_sigma=False,
                           sigma_type="relative", a=2.0, seed=0,
                           state_dtype="auto", mesh=None, axis_name="epochs",
                           summaries=None, return_chains=True):
    """Run E independent stretch-move ensembles, one per epoch, in lockstep
    on the packed tensors' device.

    ``state_dtype="auto"``: float32 walker state on CUDA (the blackbody
    parameters, T in kK, R in 1000 R_sun, sigma in dy units, are
    O(1)-O(1e3): no affine rescaling is needed), float64 on the CPU; the
    log-posterior casts to the compute dtype either way.

    ``summaries``: dict ``{"z": z, "pseudo_nu": observed-frame 1-THz grid}``
    additionally computes, on the device, the posterior summaries
    ``calculate_bolometric`` records: the 16/50/84th percentiles of T, R,
    R^2 T^4 and the c2/1e12-scaled pseudobolometric integral (the unit
    constants are applied on the host). With ``return_chains=False`` the
    chains stay on the device. ``mesh`` other than None/False raises
    NotImplementedError (ROADMAP Queue 1 item 17).

    Parameters
    ----------
    packed : output of :func:`pack_epochs`
    starting_guesses : (E, nwalkers, ndim)

    Returns
    -------
    flatchains : (E, steps*nwalkers, ndim) production samples (float64 numpy),
        or None when ``return_chains=False`` with summaries
    acceptance : (E,) mean acceptance fraction of the production steps
    summary : (E, 4, 3) float64, rows (T, R, R^2T^4, pseudo/c2/1e12), columns
        (16th, 50th, 84th percentile); only when ``summaries`` is set.
    """
    _no_mesh(mesh)
    ndim = len(priors)
    if nwalkers % 2:
        raise ValueError("nwalkers must be even")
    half = nwalkers // 2
    ep = EpochPosterior(packed, priors, cutoff_freq, use_sigma, sigma_type)
    E, dev = ep.n_epochs, ep.device
    sdt = _state_dtype(state_dtype, dev)
    guesses = np.asarray(starting_guesses, float)
    if guesses.shape != (E, nwalkers, ndim):
        raise ValueError(f"starting_guesses must be (E, nwalkers, ndim) = "
                         f"{(E, nwalkers, ndim)}, got {guesses.shape}")
    x = torch.as_tensor(guesses.reshape(E, 2, half, ndim), device=dev).to(sdt)

    def draws(i):
        g = _generator(dev, seed, i)
        shape = (E, 2, half)
        u_z = torch.rand(shape, generator=g, device=dev, dtype=sdt)
        j = torch.randint(0, half, shape, generator=g, device=dev)
        u_acc = torch.rand(shape, generator=g, device=dev, dtype=sdt)
        return u_z, j, u_acc

    return _run_ensembles(ep, x, burnin_steps, steps, draws, a, summaries, return_chains)


def _candidate_box(priors):
    """(BoundsTransform of the priors, log lower and log upper edges of the
    candidate box): the prior support clipped to a generous physical
    window, sampled log-uniformly."""
    lo = np.array([getattr(p, "p_min", -np.inf) for p in priors], float)
    up = np.array([getattr(p, "p_max", np.inf) for p in priors], float)
    bounds = BoundsTransform(lo, up)
    lo = np.where(np.isfinite(lo), np.maximum(lo, 1e-6), 0.1)
    up = np.where(np.isfinite(up), up, 100.0)
    return bounds, np.log(lo), np.log(up)


def _polish_starts(ep, cloud_u, n_starts=8):
    """The centering's first stage from given cloud uniforms ``cloud_u``
    (E, n_cloud, ndim) float64 in [0, 1): score the log-uniform cloud (K4)
    and take the ``n_starts`` best of each epoch (ties to the lower index,
    as ``lax.top_k``). Returns (the priors' BoundsTransform, the starts
    (E, n_starts, ndim) float64 in its unbounded space)."""
    bounds, log_lo, log_up = _candidate_box(ep.priors)
    dev = cloud_u.device
    cloud = torch.exp(cloud_u * torch.as_tensor(log_up - log_lo, device=dev)
                      + torch.as_tensor(log_lo, device=dev))
    scores = ep(cloud)
    scores = torch.where(torch.isfinite(scores), scores, torch.full_like(scores, -torch.inf))
    top = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :n_starts]
    starts = torch.gather(cloud, 1, top[..., None].expand(-1, -1, cloud.shape[-1]))
    return bounds, bounds.to_unbounded(starts).contiguous()


def _map_centers(ep, cloud_u, n_starts=8, n_iter=300):
    """The two centering stages from given cloud uniforms ``cloud_u``:
    :func:`_polish_starts`, then Adam from each start in the unbounded
    space, keeping each epoch's best (K4p: one launch on CUDA). Returns
    (centers (E, ndim) float64, alive (E,) bool) on the device."""
    bounds, u = _polish_starts(ep, cloud_u, n_starts)
    return epoch_bb.map_polish(ep, u, bounds, n_iter, lr=0.05, alpha=0.01)


def batched_map_centers(packed, priors, cutoff_freq=np.inf, use_sigma=False,
                        sigma_type="relative", n_starts=8, n_iter=300, seed=0,
                        fallback=None, n_cloud=512, mesh=None, axis_name="epochs"):
    """MAP centers for every epoch at once (the JAX package's fused
    two-stage centering):

    1. **Scored cloud**: ``n_cloud`` log-uniform candidates per epoch, from
       a device generator seeded by splitmix64(seed, -1), scored through K4;
       the best ``n_starts`` are kept. Pure gradient ascent from random
       starts is unreliable here: the blackbody (T, R) posterior has a
       curved Rayleigh-Jeans valley that traps Adam.
    2. **Adam polish**: ``n_starts`` ascents of the bounds-bijected
       posterior, ``n_iter`` steps of Adam under a cosine-decayed rate
       (0.05, alpha 0.01); then the best start. On CUDA one K4p launch runs
       every epoch's polish (``kernels.epoch_bb.map_polish``); ``n_starts``
       is at most 32 there.

    Epochs where every start ends non-finite fall back to ``fallback``
    (default: T=10 kK, R=10 kR_sun, sigma=1). ``mesh`` other than None/False
    raises NotImplementedError (ROADMAP Queue 1 item 17).

    Returns centers (E, ndim) float64 numpy.
    """
    _no_mesh(mesh)
    ndim = len(priors)
    if fallback is None:
        fallback = np.array([10.0, 10.0] + ([1.0] if use_sigma else []))
    ep = EpochPosterior(packed, priors, cutoff_freq, use_sigma, sigma_type)
    dev = ep.device
    cloud_u = torch.rand((ep.n_epochs, n_cloud, ndim), generator=_generator(dev, seed, -1),
                         device=dev, dtype=torch.float64)
    centers, alive = _map_centers(ep, cloud_u, n_starts, n_iter)
    centers = centers.detach().cpu().numpy()
    dead = ~alive.cpu().numpy()
    if dead.any():
        centers = np.where(dead[:, None], fallback, centers)
    return centers
