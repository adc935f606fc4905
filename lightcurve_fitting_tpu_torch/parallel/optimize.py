"""Batched gradient optimization (the port of the JAX package's
``parallel/optimize.py``): many independent starts in one state tensor, and
the Laplace covariance at a mode.

:func:`multistart_maximize` ascends a batched log-probability; with a
LogPosterior on CUDA each iteration's value and gradient come from one K7
launch (``LogPosterior.forward`` under autograd). :func:`laplace_covariance`
forms the Hessian of a LogPosterior by central differences of K7's float64
gradient, one launch on 2 x (free parameters) points.

The optimizer is optax's ``adam(cosine_decay_schedule(lr, n, alpha))``
step for step on a batched tensor of starts.

The JAX package runs ``optax.adam`` in the MAP centering of the bolometric
path (``parallel/batched.py::batched_map_centers``) and in
``parallel/optimize.py::multistart_maximize``. :class:`CosineAdam` is that
optimizer written out, so a whole batch of starts is one state tensor
(``torch.optim.Adam`` keeps per-parameter state and reads its learning rate
after the step count moves). optax's semantics, kept exactly:

* the schedule is read at the 0-based count *before* its increment,
  ``lr(t) = lr0 ((1 - alpha) (1 + cos(pi min(t, n) / n)) / 2 + alpha)``;
* ``b1 = 0.9``, ``b2 = 0.999``, ``eps = 1e-8``, ``eps_root = 0``;
* the bias corrections use the count after its increment;
* the update is ``-lr(t) m_hat / (sqrt(v_hat) + eps)``, added to the
  parameters (minimization, as ``optax.apply_updates``).
"""

import math

import numpy as np
import torch

__all__ = ["cosine_decay_lr", "CosineAdam", "multistart_maximize", "laplace_covariance",
           "FD_STEP"]

B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults, the only values in use


def cosine_decay_lr(t, lr0, n_iter, alpha=0.0):
    """optax.cosine_decay_schedule(lr0, n_iter, alpha) at count ``t``."""
    count = min(float(t), float(n_iter))
    cosine_decay = 0.5 * (1 + math.cos(math.pi * count / float(n_iter)))
    return lr0 * ((1 - alpha) * cosine_decay + alpha)


class CosineAdam:
    """Adam under a cosine-decay learning rate on one parameter tensor of
    any shape (every element its own coordinate); ``step(u, g)`` returns the
    updated parameters for gradient ``g`` of the loss being minimized."""

    def __init__(self, like, lr=0.05, n_iter=300, alpha=0.01):
        if not n_iter > 0:
            raise ValueError(f"the cosine decay needs positive n_iter, got {n_iter}")
        self.lr, self.n_iter, self.alpha = lr, n_iter, alpha
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0

    def scalars(self, count):
        """The host scalars of the step at 0-based ``count``: the learning
        rate and the bias corrections 1 - b1^(count + 1), 1 - b2^(count + 1)."""
        count_inc = count + 1
        return (cosine_decay_lr(count, self.lr, self.n_iter, self.alpha), 1 - B1 ** count_inc,
                1 - B2 ** count_inc)

    def step(self, u, g):
        self.mu = (1 - B1) * g + B1 * self.mu
        self.nu = (1 - B2) * (g * g) + B2 * self.nu
        lr, corr1, corr2 = self.scalars(self.count)
        mu_hat = self.mu / corr1
        nu_hat = self.nu / corr2
        self.count += 1
        return u + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + EPS))


def _value_and_grad(fn, u):
    with torch.enable_grad():
        u = u.detach().requires_grad_(True)
        v = fn(u)
        g, = torch.autograd.grad(v.sum(), u)
    return v.detach(), g


def multistart_maximize(log_prob_fn, u0, n_iter=1000, learning_rate=0.05):
    """Maximize ``log_prob_fn(u (S, ndim)) -> (S,)`` from every row of
    ``u0`` at once (optimize.py:19-48 of the JAX package): Adam under a
    cosine-decayed step size (:class:`CosineAdam`), gradients by autograd.

    Non-finite gradients are zeroed per start, so a start that wanders into
    a -inf plateau stalls without poisoning the batch. The final values come
    from the same evaluation path as the gradients.

    Returns ``(u_final, logp_final)``, tensors (S, ndim) and (S,) on
    ``u0``'s device (the CPU for a numpy ``u0``)."""
    u = torch.atleast_2d(torch.as_tensor(u0, dtype=torch.float64))
    opt = CosineAdam(u, lr=learning_rate, n_iter=n_iter, alpha=0.01)
    for _ in range(n_iter):
        _, g = _value_and_grad(log_prob_fn, u)
        g = -g
        u = opt.step(u, torch.where(torch.isfinite(g), g, torch.zeros_like(g)))
    return u, _value_and_grad(log_prob_fn, u)[0]


#: the central-difference step of :func:`laplace_covariance` on a
#: LogPosterior, relative to each parameter's scale
FD_STEP = 1e-5


def _hessian(log_prob_fn, x_map, free):
    """The Hessian of ``log_prob_fn`` at ``x_map`` (ndim,) float64, exact
    (autograd) for a torch callable; for a LogPosterior its free columns by
    central differences of the float64 gradient (K7 on CUDA, its plain
    version on the CPU), one evaluation of 2 n_free points.

    Step rule: h_i = FD_STEP x (p_max - p_min) of prior i when both bounds
    are finite, else FD_STEP x max(|x_i|, 1). With float64 gradients the
    free block of the flagship's Hessian at the JAX package's MAP point is
    within 1e-8 of its largest entry of jax.hessian's (9.6e-10 measured on
    the CPU; tests/test_torch_grad.py)."""
    from .. import kernels
    from ..fitting import LogPosterior
    ndim = x_map.shape[0]
    if not isinstance(log_prob_fn, LogPosterior):
        return torch.autograd.functional.hessian(lambda x: log_prob_fn(x[None])[0], x_map)
    if log_prob_fn.log_likelihood.compute_dtype != torch.float64:
        raise ValueError("the finite-difference Hessian needs a float64 LogPosterior")
    x_map = x_map.to(log_prob_fn.log_likelihood.t.device)
    idx = np.flatnonzero(free)
    scale = np.array([p.p_max - p.p_min if np.isfinite(p.p_max - p.p_min)
                      else max(abs(float(x)), 1.0)
                      for p, x in zip(log_prob_fn.priors, x_map.tolist())])
    h = torch.as_tensor(FD_STEP * scale[idx], dtype=torch.float64, device=x_map.device)
    k = idx.size
    pts = x_map.repeat(2 * k, 1)
    cols = torch.as_tensor(idx, device=x_map.device)
    rows = torch.arange(k, device=x_map.device)
    pts[rows, cols] += h
    pts[k + rows, cols] -= h
    _, g = kernels.log_posterior_and_grad(log_prob_fn, pts)
    H = torch.zeros((ndim, ndim), dtype=torch.float64, device=x_map.device)
    H[:, cols] = ((g[:k] - g[k:]) / (2.0 * h[:, None])).T
    return H


def laplace_covariance(log_prob_fn, x_map, free=None):
    """Covariance of the Laplace (quadratic) approximation at a mode,
    ``inv(-hessian(log_prob))`` (optimize.py:51-82 of the JAX package).

    ``log_prob_fn``: a float64 LogPosterior (finite-difference Hessian of
    K7's gradient) or a batched torch callable (autograd Hessian). ``free``
    is a boolean mask of parameters to treat as varying; the others (e.g.
    pinned against a prior bound) get zero rows and columns: the free block
    is the curvature conditional on the pinned values.

    Returns ``(cov, ok)`` (numpy); ``ok`` is False when the free-block
    negative Hessian is not positive definite, and its eigenvalues are then
    clipped so that the result stays usable as a draw covariance."""
    x = torch.tensor(np.asarray(x_map, float))
    ndim = x.shape[0]
    free = np.ones(ndim, bool) if free is None else np.asarray(free, bool)
    cov = np.zeros((ndim, ndim))
    if not free.any():
        return cov, False
    H = _hessian(log_prob_fn, x, free).cpu().numpy()
    A = -0.5 * (H + H.T)  # symmetrize
    A = A[np.ix_(free, free)]
    try:
        np.linalg.cholesky(A)
        cov[np.ix_(free, free)] = np.linalg.inv(A)
        return cov, True
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(A)
        w = np.maximum(w, 1e-12 * np.abs(w).max())
        cov[np.ix_(free, free)] = (V / w) @ V.T
        return cov, False
