"""No-U-Turn sampler (multinomial NUTS, Hoffman & Gelman 2014; Betancourt
2017), the port of the JAX package's ``parallel/nuts.py``.

A transition keeps every visited state of a subtree in a buffer of
``2^(max_depth - 1)`` rows, so the subtree U-turn checks are reductions over
aligned power-of-two blocks, with no recursion. Divergences (|dH| > 1000)
invalidate the subtree, as in Stan.

On CUDA a transition of every chain is one launch of K9
(``nuts_transition_kernel``, ``kernels/csrc/gradient.cuh``) over a
WhitenedLogPosterior of ShockCooling2; :func:`make_nuts_transition` is its
plain version, batched over chains with the draws as inputs, which also
runs any torch log-probability on the CPU. The sampler's warmup, production
loop and continuation are those of :class:`~.hmc.GradientSampler`.
"""

import math

import torch

from .hmc import GradientSampler

__all__ = ["NUTSSampler", "make_nuts_transition"]

_DIVERGENCE = 1000.0


def _max_len(max_depth):
    return 2 ** (max_depth - 1) if max_depth > 1 else 1


def _leapfrog(logp_and_grad, q, p, g, eps, inv_mass):
    """One kick-drift-kick step reusing the entry gradient ``g`` (the
    previous step's exit gradient); ``eps`` (B, 1) carries each chain's
    direction. Returns (q, p, logp, exit gradient)."""
    p = p + 0.5 * eps * g
    q = q + eps * inv_mass * p
    logp, g2 = logp_and_grad(q)
    p = p + 0.5 * eps * g2
    return q, p, logp, g2


def _dot_margin(V, dq):
    """(sum V dq < 0, |sum V dq| / sum |V dq|) over the last axis: the
    U-turn criterion and how far its sign is from flipping."""
    t = V * dq
    dot = torch.sum(t, dim=-1)
    return dot < 0.0, torch.nan_to_num(dot.abs() / torch.sum(t.abs(), dim=-1), nan=math.inf)


def _subtree_turns(Q, P, n_new, direction, inv_mass):
    """Any U-turn inside the subtree of ``n_new`` states Q, P (B, n_new,
    ndim): the endpoints of every aligned power-of-two block, ``direction``
    (B,) orienting the displacement into forward time. Returns (turned,
    the smallest relative margin of the criteria checked)."""
    V = P * inv_mass
    turned = torch.zeros(Q.shape[0], dtype=torch.bool, device=Q.device)
    margin = torch.full((Q.shape[0],), math.inf, dtype=Q.dtype, device=Q.device)
    size = 2
    while size <= n_new:
        s = torch.arange(0, n_new - size + 1, size, device=Q.device)
        e = s + size - 1
        dq = direction[:, None, None] * (Q[:, e] - Q[:, s])
        for ends in (s, e):
            bad, m = _dot_margin(V[:, ends], dq)
            turned = turned | bad.any(dim=-1)
            margin = torch.minimum(margin, m.min(dim=-1).values)
        size *= 2
    return turned, margin


def _ends_turn(q_l, p_l, q_r, p_r, inv_mass):
    """(the U-turn between the tree's ends, its relative margin)."""
    dq = q_r - q_l
    bad_l, m_l = _dot_margin(p_l * inv_mass, dq)
    bad_r, m_r = _dot_margin(p_r * inv_mass, dq)
    return bad_l | bad_r, torch.minimum(m_l, m_r)


def make_nuts_transition(logp_and_grad, ndim, max_depth=8, margins=False):
    """Build ``transition(q, logp, z, u, eps, inv_mass) -> (q', logp',
    accept_stat, depth, diverged)`` over a batch of C chains (nuts.py:98-204
    of the JAX package, batched; each chain's loop over doublings runs until
    it turns, diverges or reaches ``max_depth``).

    With ``margins`` the transition also returns, per chain, how close its
    decisions came to going the other way: the smallest gap in nats of the
    progressive accept, the Gumbel pick (best against second best) and the
    divergence threshold, and the smallest relative margin of a U-turn
    criterion (comparisons with another implementation count a chain whose
    outcome differs as a near-tie when these are within its rounding).

    ``logp_and_grad`` maps (B, ndim) states to (log p (B,), masked gradient
    (B, ndim)). Draws: ``z`` (C, ndim) normals, the momentum z /
    sqrt(inv_mass); ``u`` (C, max_depth, 2^(max_depth-1) + 2) uniforms per
    doubling: [0] the direction (+1 when < 0.5), [1 .. 2^(max_depth-1)] the
    Gumbel pick, [-1] the progressive-sampling accept."""
    max_len = _max_len(max_depth)

    def transition(q0, logp0, z, u, eps, inv_mass):
        C = q0.shape[0]
        dev, dt = q0.device, q0.dtype
        p0 = z / torch.sqrt(inv_mass)
        h0 = -logp0 + 0.5 * torch.sum(p0 * p0 * inv_mass, dim=-1)
        q_l, p_l, q_r, p_r = q0.clone(), p0.clone(), q0.clone(), p0.clone()
        q_prop, logp_prop = q0.clone(), logp0.clone()
        logW = torch.zeros(C, dtype=dt, device=dev)   # the accepted tree's (w0 = 1)
        turned = torch.zeros(C, dtype=torch.bool, device=dev)
        diverged = torch.zeros_like(turned)
        depth = torch.zeros(C, dtype=torch.int32, device=dev)
        a_sum = torch.zeros(C, dtype=dt, device=dev)
        a_cnt = torch.zeros(C, dtype=dt, device=dev)
        m_energy = torch.full((C,), math.inf, dtype=dt, device=dev)
        m_turn = torch.full((C,), math.inf, dtype=dt, device=dev)
        for d in range(max_depth):
            idx = torch.nonzero(~(turned | diverged)).squeeze(1)
            if idx.numel() == 0:
                break
            ud = u[idx, d]
            direction = torch.where(ud[:, 0] < 0.5, 1.0, -1.0).to(dt)
            fwd = (direction > 0)[:, None]
            n_steps = 2 ** d
            # build the subtree from the chosen end: one evaluation seeds it,
            # every later step reuses its predecessor's exit gradient
            q = torch.where(fwd, q_r[idx], q_l[idx])
            p = torch.where(fwd, p_r[idx], p_l[idx])
            _, g = logp_and_grad(q)
            eps_d = (direction * eps)[:, None]
            Qs, Ps, lws, lps = [], [], [], []
            for _ in range(n_steps):
                q, p, logp, g = _leapfrog(logp_and_grad, q, p, g, eps_d, inv_mass)
                h = -logp + 0.5 * torch.sum(p * p * inv_mass, dim=-1)
                h = torch.where(torch.isnan(h), torch.full_like(h, math.inf), h)
                Qs.append(q)
                Ps.append(p)
                lws.append(h0[idx] - h)
                lps.append(logp)
            Q, P = torch.stack(Qs, 1), torch.stack(Ps, 1)
            logw, logps = torch.stack(lws, 1), torch.stack(lps, 1)
            div_new = torch.any(logw < -_DIVERGENCE, dim=1)
            turned_sub, turn_margin = _subtree_turns(Q, P, n_steps, direction, inv_mass)
            bad = turned_sub | div_new
            logW_new = torch.logsumexp(logw, dim=1)
            # multinomial draw from the subtree via Gumbel argmax (the first
            # index wins a tie)
            gumbel = -torch.log(-torch.log(ud[:, 1:1 + n_steps]))
            pick = torch.argmax(logw + gumbel, dim=1)
            rows = torch.arange(idx.numel(), device=dev)
            alpha_sum = torch.sum(torch.clamp(torch.exp(logw), max=1.0), dim=1)
            # biased progressive sampling: the subtree's pick with
            # probability min(1, W_new / W_old)
            logW_old = logW[idx]
            take = (torch.log(ud[:, max_len + 1]) < (logW_new - logW_old)) & ~bad
            q_prop[idx] = torch.where(take[:, None], Q[rows, pick], q_prop[idx])
            logp_prop[idx] = torch.where(take, logps[rows, pick], logp_prop[idx])
            q_l2 = torch.where(fwd, q_l[idx], q)
            p_l2 = torch.where(fwd, p_l[idx], p)
            q_r2 = torch.where(fwd, q, q_r[idx])
            p_r2 = torch.where(fwd, p, p_r[idx])
            # a bad subtree ends the growth without being merged
            keep = bad[:, None]
            logW[idx] = torch.where(bad, logW[idx], torch.logaddexp(logW[idx], logW_new))
            ends_bad, ends_margin = _ends_turn(q_l2, p_l2, q_r2, p_r2, inv_mass)
            turned[idx] = bad | ends_bad
            if margins:
                keys = torch.sort(logw + gumbel, dim=1, descending=True).values
                gaps = [torch.nan_to_num((torch.log(ud[:, max_len + 1]) - logW_new
                                          + logW_old).abs(), nan=math.inf),
                        (logw + _DIVERGENCE).abs().min(dim=1).values]
                if n_steps > 1:
                    gaps.append(torch.nan_to_num(keys[:, 0] - keys[:, 1], nan=math.inf))
                for gap in gaps:
                    m_energy[idx] = torch.minimum(m_energy[idx], gap)
                m_turn[idx] = torch.minimum(m_turn[idx], torch.minimum(turn_margin, ends_margin))
            q_l[idx] = torch.where(keep, q_l[idx], q_l2)
            p_l[idx] = torch.where(keep, p_l[idx], p_l2)
            q_r[idx] = torch.where(keep, q_r[idx], q_r2)
            p_r[idx] = torch.where(keep, p_r[idx], p_r2)
            diverged[idx] = diverged[idx] | div_new
            depth[idx] += 1
            a_sum[idx] += alpha_sum
            a_cnt[idx] += float(n_steps)
        accept_stat = a_sum / torch.clamp(a_cnt, min=1.0)
        if margins:
            return q_prop, logp_prop, accept_stat, depth, diverged, m_energy, m_turn
        return q_prop, logp_prop, accept_stat, depth, diverged

    return transition


class NUTSSampler(GradientSampler):
    """Multi-chain adaptive NUTS: the API of the JAX package's NUTSSampler
    (``run_mcmc(initial, n_samples, n_warmup)``, ``flatchain``, ``chain``,
    ``acceptance_fraction`` (the mean accept statistic), ``mean_tree_depth``,
    ``divergence_rate``, the adapted ``step_size`` and ``inv_mass``), plus
    ``device`` (default CUDA, raising without it). On CUDA each transition is
    one launch of K9 over a WhitenedLogPosterior of ShockCooling2; ``mesh``
    raises NotImplementedError (ROADMAP Queue 1 item 17)."""

    def __init__(self, nchains, ndim, log_prob_fn, max_depth=8, target_accept=0.8,
                 init_step_size=0.1, init_scales=None, seed=None, mesh=None, device=None):
        self.max_depth = int(max_depth)
        super().__init__(nchains, ndim, log_prob_fn, target_accept, init_step_size,
                         init_scales, seed, mesh, device)

    def _draws(self, i):
        """(z (C, ndim), u (C, max_depth, 2^(max_depth-1) + 2)) of global
        transition ``i``."""
        g, dev, C = self._seeded(i), self.device, self.nchains
        z = torch.randn((C, self.ndim), generator=g, device=dev, dtype=torch.float64)
        u = torch.rand((C, self.max_depth, _max_len(self.max_depth) + 2), generator=g,
                       device=dev, dtype=torch.float64)
        return z, u

    def _step(self, x, logp, draws, eps, inv_mass, out=None):
        from .. import kernels
        return kernels.nuts_transition(self._target, x, logp, *draws, eps, inv_mass,
                                       self.max_depth, out=out)

    @property
    def mean_tree_depth(self):
        return float(self._depth_sum.sum() / max(self._nsteps * self.nchains, 1))

    @property
    def divergence_rate(self):
        return float(self._divergences.sum() / max(self._nsteps * self.nchains, 1))
