"""Gradient ascent helpers: optax's ``adam(cosine_decay_schedule(lr, n, alpha))``
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

import torch

__all__ = ["cosine_decay_lr", "CosineAdam"]

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

    def step(self, u, g):
        self.mu = (1 - B1) * g + B1 * self.mu
        self.nu = (1 - B2) * (g * g) + B2 * self.nu
        count_inc = self.count + 1
        mu_hat = self.mu / (1 - B1 ** count_inc)
        nu_hat = self.nu / (1 - B2 ** count_inc)
        lr = cosine_decay_lr(self.count, self.lr, self.n_iter, self.alpha)
        self.count = count_inc
        return u + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + EPS))
