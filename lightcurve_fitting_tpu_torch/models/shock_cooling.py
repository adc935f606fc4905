"""Shock-cooling models of Sapir & Waxman (2017): the scaled parametrization
ShockCooling2 (reference models.py:356-430), the flagship model, and the
physical parametrization with distance and E(B-V) free, ShockCooling3
(reference models.py:433-504), which runs the exact quadrature.

The physical table-path ShockCooling and Morag, Sapir & Waxman (2023)
(ShockCooling4) wait for ROADMAP Queue 1 item 7.
"""

import numpy as np
import torch

from ..core.constants import c3_42, c4_30, k_B
from ..ops.mathx import power, hot, hot_phase
from ..utils import units as u
from .base import Model
from .blackbody import bandflux_pointwise, bandflux_pointwise_plain

__all__ = ["BaseShockCooling", "ShockCooling2", "ShockCooling3"]


class BaseShockCooling(Model):
    """Sapir & Waxman (2017) shock cooling (reference models.py:139-298):
    the model constants for a polytropic index n = 1.5 or 3, the
    Rabinak & Waxman variant (RW) and the opacity kappa (in 0.34 cm^2/g).

    T(t) = (T_col/T_ph) T_0 (v_s^2 t^2 / (f_rho M kappa))^eps1 R^(1/4) kappa^(-1/4) t^(-1/2)
    L(t) = A exp[-(a t / t_tr)^alpha] L_0 (v_s t^2/(f_rho M kappa))^(-eps2) v_s^2 R / kappa
    t_tr = 19.5 d sqrt(kappa M_env / v_s)
    """

    def __init__(self, lc=None, redshift=0.0, n=1.5, RW=False, kappa=1.0, device=None):
        super().__init__(lc, redshift=redshift, device=device)
        self.kappa = float(kappa)
        if n == 1.5:
            self.n = 1.5
            self.A = 0.94
            self.a = 1.67
            self.alpha = 0.8
            self.epsilon_1 = 0.027
            self.epsilon_2 = 0.086
            self.L_0 = 2.0e42   # erg/s
            self.T_0 = 1.61     # eV
            self.Tph_to_Tcol = 1.1
        elif n == 3.0:
            self.n = 3.0
            self.A = 0.79
            self.a = 4.57
            self.alpha = 0.73
            self.epsilon_1 = 0.016
            self.epsilon_2 = 0.175
            self.L_0 = 2.1e42
            self.T_0 = 1.69
            self.Tph_to_Tcol = 1.0
        else:
            raise ValueError("n can only be 1.5 or 3")
        self.epsilon_T = 2 * self.epsilon_1 - 0.5
        self.epsilon_L = -2 * self.epsilon_2
        if RW:
            self.RW = True
            self.a = 0.0
            self.Tph_to_Tcol = 1.2
        else:
            self.RW = False

    def __repr__(self):
        return f"<{self.__class__.__name__}: z={self.z:.3f}, n={self.n:.1f}, RW={self.RW}>"

    def _sw17(self, tt, v_s, M_env, f_rho_M, R, kappa):
        """Color temperature (kK) and blackbody radius (1000 Rsun) at elapsed
        times ``tt`` (SW17 Eq. 18-23), in the hot-path dtype, with the JAX
        package's operation order. Luminosity is carried in 1e42 erg/s."""
        tt, v_s, M_env, f_rho_M, R, kappa = hot(tt.device, tt, v_s, M_env, f_rho_M, R, kappa)
        L_RW_42 = (self.L_0 / 1e42) * power(tt ** 2 * v_s / (f_rho_M * kappa),
                                            -self.epsilon_2) * v_s ** 2 * R / kappa
        t_tr = 19.5 * (kappa * M_env / v_s) ** 0.5
        L_42 = L_RW_42 * self.A * torch.exp(-power(self.a * tt / t_tr, self.alpha))
        T_ph = (self.T_0 * power(tt ** 2 * v_s ** 2 / (f_rho_M * kappa), self.epsilon_1)
                * kappa ** -0.25 * power(tt, -0.5) * R ** 0.25)
        T_K = T_ph * self.Tph_to_Tcol / k_B
        R_bb = c3_42 * L_42 ** 0.5 * power(T_K, -2.0)
        return T_K, R_bb

    def temperature_radius(self, t_in, v_s, M_env, f_rho_M, R, t_exp=0.0, kappa=None):
        """Color temperature (kK) and blackbody radius (1000 Rsun) vs time
        (reference models.py:231-269), outer-broadcast over vector
        parameters like the reference."""
        dev = self.device

        def f64(x):
            return torch.as_tensor(np.asarray(x, float), dtype=torch.float64, device=dev)

        if kappa is None:
            kappa = self.kappa
        t = hot_phase(f64(t_in).reshape(-1, 1), f64(t_exp))
        T_K, R_bb = self._sw17(t, *(f64(x) for x in (v_s, M_env, f_rho_M, R, kappa)))
        return torch.squeeze(T_K), torch.squeeze(R_bb)

    def _tr_points(self, t, v_s, M_env, f_rho_M, R, t_exp=0.0, kappa=None):
        """T_K, R_bb (W, N) at the points' times ``t`` (N,) for (W, 1)
        parameter columns (or 0-d parameters: (N,))."""
        if kappa is None:
            kappa = self.kappa
        return self._sw17(hot_phase(t, t_exp), v_s, M_env, f_rho_M, R, kappa)

    def _eval_points(self, t, quad, *params, plain=False):
        T_K, R_bb = self._tr_points(t, *params)
        return self._bandflux(quad, T_K, R_bb, plain=plain)

    def t_min(self, p, kappa=None):
        """Earliest validity time, SW17 Eq. 17 (reference models.py:275-287).
        ``kappa`` defaults to the constructor's opacity."""
        if kappa is None:
            kappa = self.kappa
        v_s, f_rho_M, R = p[0], p[2], p[3]
        t_exp = p[4] if len(p) > 4 else 0.0
        return 0.2 * R / v_s * np.maximum(0.5, R ** 0.4 * (f_rho_M * kappa) ** -0.2
                                          * v_s ** -0.7) + t_exp

    def t_max(self, p, kappa=None):
        """Latest validity time, SW17 Eq. 24 (reference models.py:289-298)."""
        if kappa is None:
            kappa = self.kappa
        R = p[3]
        t_exp = p[4] if len(p) > 4 else 0.0
        return 7.4 * (R / kappa) ** 0.55 + t_exp


class ShockCooling2(BaseShockCooling):
    """SW17 in scaling parameters T_1, L_1, t_tr (reference models.py:356-430):
    T(t) = T_1 t^eps_T ;  L(t) = L_1 t^eps_L exp[-(a t/t_tr)^alpha]."""

    input_names = ["T_1", "L_1", "t_\\mathrm{tr}", "t_0"]
    units = [u.kK, 1e42 * u.erg / u.s, u.d, u.d]

    def evaluate(self, t_in, f, T_1, L_1, t_tr, t_exp=0.0):
        return super().evaluate(t_in, f, T_1, L_1, t_tr, t_exp)

    def _tr_points(self, t, T_1, L_1, t_tr, t_exp=0.0):
        tt = hot_phase(t, t_exp)
        tt, T_1, L_1, t_tr = hot(tt.device, tt, T_1, L_1, t_tr)
        T_K = T_1 * power(tt, self.epsilon_T)
        L_42 = L_1 * torch.exp(-power(self.a * tt / t_tr, self.alpha)) * power(tt, self.epsilon_L)
        R_bb = c3_42 * L_42 ** 0.5 * power(T_K, -2.0)
        return T_K, R_bb

    def temperature_radius(self, t_in, T_1, L_1, t_tr, t_exp=0.0):
        """Color temperature (kK) and blackbody radius (1000 Rsun) vs time,
        outer-broadcast over vector parameters like the reference."""
        dev = self.device

        def f64(x):
            return torch.as_tensor(x, dtype=torch.float64, device=dev)

        t = f64(t_in).reshape(-1, 1) - f64(t_exp)
        t, T_1, L_1, t_tr = hot(dev, t, f64(T_1), f64(L_1), f64(t_tr))
        T_K = torch.squeeze(T_1 * power(t, self.epsilon_T))
        L_42 = torch.squeeze(L_1 * torch.exp(-power(self.a * t / t_tr, self.alpha))
                             * power(t, self.epsilon_L))
        R_bb = c3_42 * L_42 ** 0.5 * power(T_K, -2.0)
        return T_K, R_bb

    def kernel_constants(self):
        """The exponents and shape constants K1 evaluates in-kernel."""
        return {"eps_T": self.epsilon_T, "eps_L": self.epsilon_L,
                "a": self.a, "alpha": self.alpha}

    @staticmethod
    def t_min(p, kappa=1.0):
        raise NotImplementedError(
            "ShockCooling2 has no validity lower bound; its scaled parameters "
            "(T_1, L_1, t_tr) do not determine SW17's t_min")

    def t_max(self, p, kappa=1.0):
        """t_max = (8.12 kK / T_1)^(1/eps_T) + t_exp (reference models.py:422-430)."""
        T_1 = p[0]
        t_exp = p[3] if len(p) > 3 else 0.0
        return (8.12 / T_1) ** (self.epsilon_T ** -1) + t_exp


class ShockCooling3(BaseShockCooling):
    """SW17 in physical parameters with luminosity distance and E(B-V) free
    (reference models.py:433-504). Output is flux. E(B-V) is sampled, so
    extinction does not factorize out of the band integral: the exact
    quadrature runs, with the F99 curve precomputed at the nodes."""

    input_names = ["v_\\mathrm{s*}", "M_\\mathrm{env}", "f_\\rho M", "R", "d_L", "E(B-V)", "t_0"]
    units = [10.0 ** 8.5 * u.cm / u.s, u.Msun, u.Msun, 1e13 * u.cm, u.Mpc, u.mag, u.d]
    output_quantity = "flux"
    use_band_table = False  # sampled E(B-V): extinction does not factorize

    def evaluate(self, t_in, f, v_s, M_env, f_rho_M, R, dist, ebv=0.0, t_exp=0.0, kappa=None):
        if kappa is None:
            kappa = self.kappa
        return Model.evaluate(self, t_in, f, v_s, M_env, f_rho_M, R, dist, ebv, t_exp, kappa)

    def _eval_points(self, t, quad, v_s, M_env, f_rho_M, R, dist, ebv=0.0, t_exp=0.0,
                     kappa=None, plain=False):
        T_K, R_bb = self._tr_points(t, v_s, M_env, f_rho_M, R, t_exp, kappa)
        flux = bandflux_pointwise_plain if plain else bandflux_pointwise
        lum = flux(quad["nodes"], quad["weights"], T_K, R_bb, k_ext=quad["k_ext"], ebv=ebv)
        # the JAX package splits c4 ~ 8e-47 for its float32-range float64;
        # the same split keeps both packages computing the same quantities
        return ((lum * 1e-30) * c4_30) / dist ** 2.0

    def kernel_constants(self):
        """The SW17 constants the fused SC3 log-posterior evaluates in-kernel."""
        return {"kappa": self.kappa, "A": self.A, "a": self.a, "alpha": self.alpha,
                "eps1": self.epsilon_1, "eps2": self.epsilon_2, "L0_42": self.L_0 / 1e42,
                "T0": self.T_0, "tph_to_tcol": self.Tph_to_Tcol}

    def t_min(self, p, kappa=None):
        return BaseShockCooling.t_min(self, [p[0], p[1], p[2], p[3],
                                             p[6] if len(p) > 6 else 0.0], kappa=kappa)

    def t_max(self, p, kappa=None):
        return BaseShockCooling.t_max(self, [p[0], p[1], p[2], p[3],
                                             p[6] if len(p) > 6 else 0.0], kappa=kappa)
