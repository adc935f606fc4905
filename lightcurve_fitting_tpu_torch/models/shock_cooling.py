"""Shock-cooling models: Sapir & Waxman (2017) in three parametrizations and
Morag, Sapir & Waxman (2023). ShockCooling (reference models.py:301-353) is
SW17 in physical parameters, ShockCooling2 (:356-430) the scaled
parametrization of the flagship fit, ShockCooling3 (:433-504) the physical
one with distance and E(B-V) free, which runs the exact quadrature, and
ShockCooling4 (:507-657) MSW23 over SW17's physical parameters.
"""

import numpy as np
import torch

from ..core.constants import c3_42, c4_30, k_B
from ..ops.mathx import power, hot, hot_phase
from ..utils import units as u
from .base import Model
from .blackbody import bandflux_pointwise, bandflux_pointwise_plain

__all__ = ["BaseShockCooling", "ShockCooling", "ShockCooling2", "ShockCooling3",
           "ShockCooling4"]


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
        self._init_options = {"n": n, "RW": RW, "kappa": kappa}
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


class ShockCooling(BaseShockCooling):
    """SW17 in physical parameters v_s*, M_env, f_rho M, R (reference
    models.py:301-353). ``kappa`` is bound at construction (the fits use
    it) and may be overridden per :meth:`evaluate`."""

    input_names = ["v_\\mathrm{s*}", "M_\\mathrm{env}", "f_\\rho M", "R", "t_0"]
    units = [10.0 ** 8.5 * u.cm / u.s, u.Msun, u.Msun, 1e13 * u.cm, u.d]

    def evaluate(self, t_in, f, v_s, M_env, f_rho_M, R, t_exp=0.0, kappa=None):
        if kappa is None:
            kappa = self.kappa
        return super().evaluate(t_in, f, v_s, M_env, f_rho_M, R, t_exp, kappa)

    def kernel_constants(self):
        """The SW17 constants the fused SC log-posterior evaluates in-kernel."""
        return _sw17_constants(self)


def _sw17_constants(model):
    return {"kappa": model.kappa, "A": model.A, "a": model.a, "alpha": model.alpha,
            "eps1": model.epsilon_1, "eps2": model.epsilon_2, "L0_42": model.L_0 / 1e42,
            "T0": model.T_0, "tph_to_tcol": model.Tph_to_Tcol}


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
        return _sw17_constants(self)

    def t_min(self, p, kappa=None):
        return BaseShockCooling.t_min(self, [p[0], p[1], p[2], p[3],
                                             p[6] if len(p) > 6 else 0.0], kappa=kappa)

    def t_max(self, p, kappa=None):
        return BaseShockCooling.t_max(self, [p[0], p[1], p[2], p[3],
                                             p[6] if len(p) > 6 else 0.0], kappa=kappa)


class ShockCooling4(Model):
    """Morag, Sapir & Waxman (2023) shock cooling (reference
    models.py:507-657) over SW17's physical parameters (v_s*, M_env,
    f_rho M, R, t_0). Like the JAX package it follows the published MSW23
    Eq. A7/A9, not the reference's operator-precedence slips (its lines 586
    and 656)."""

    input_names = ["v_\\mathrm{s*}", "M_\\mathrm{env}", "f_\\rho M", "R", "t_0"]
    units = [10.0 ** 8.5 * u.cm / u.s, u.Msun, u.Msun, 1e13 * u.cm, u.d]

    def __init__(self, lc=None, redshift=0.0, kappa=1.0, device=None):
        super().__init__(lc, redshift=redshift, device=device)
        self._init_options = {"kappa": kappa}
        self.kappa = float(kappa)
        self.A = 0.9
        self.a = 2.0
        self.alpha = 0.5
        self.L_br_0 = 3.69e42   # erg/s (Eq. A6)
        self.T_col_br_0 = 8.19  # eV (Eq. A7)
        self.t_min_0 = 0.012    # d = 17 min (Eq. A3)
        self.t_br_0 = 0.036     # d = 0.86 h (Eq. A5)
        self.t_07eV_0 = 6.86    # d (Eq. A8)
        self.t_tr_0 = 19.5      # d (Eq. A9)

    def _tr_points(self, t, v_s, M_env, f_rho_M, R, t_exp=0.0, kappa=None):
        """T_K, R_bb at the points' times ``t`` (N,) for (W, 1) parameter
        columns (or 0-d parameters: (N,)), with the JAX package's operation
        order: the breakout scales t_br, L_br, T_col,br and t_tr in float64
        from the float64 parameters, cast to the hot-path dtype afterwards."""
        if kappa is None:
            kappa = self.kappa
        t_br = self.t_br_0 * R ** 1.26 * v_s ** -1.13 * f_rho_M ** -0.13        # Eq. A5
        L_br_42 = ((self.L_br_0 / 1e42) * R ** 0.78 * v_s ** 2.11 * f_rho_M ** 0.11
                   * kappa ** -0.89)                                             # Eq. A6
        T_col_br = self.T_col_br_0 * R ** -0.32 * v_s ** 0.58 * f_rho_M ** 0.03 * kappa ** -0.22
        t_tr = self.t_tr_0 * torch.sqrt(kappa * M_env / v_s)                   # Eq. A9
        tt = hot_phase(t, t_exp)
        tt, t_br, L_br_42, T_col_br, t_tr = hot(tt.device, tt, t_br, L_br_42, T_col_br, t_tr)
        ttilde = tt / t_br
        L_42 = L_br_42 * (power(ttilde, -4.0 / 3.0)
                          + self.A * torch.exp(-power(self.a * tt / t_tr, self.alpha))
                          * power(ttilde, -0.17))                              # Eq. A1
        T_col = T_col_br * torch.minimum(0.97 * power(ttilde, -1.0 / 3.0),
                                         power(ttilde, -0.45))                 # Eq. A2
        T_K = T_col / k_B
        R_bb = c3_42 * L_42 ** 0.5 * power(T_K, -2.0)
        return T_K, R_bb

    def temperature_radius(self, t_in, v_s, M_env, f_rho_M, R, t_exp=0.0, kappa=None):
        """Color temperature (kK) and blackbody radius (1000 Rsun) vs time,
        outer-broadcast over vector parameters like the JAX package."""
        dev = self.device

        def f64(x):
            return torch.as_tensor(np.asarray(x, float), dtype=torch.float64, device=dev)

        t = f64(t_in).reshape(-1, 1) - f64(t_exp)
        T_K, R_bb = self._tr_points(t, *(f64(x) for x in (v_s, M_env, f_rho_M, R)), 0.0,
                                    None if kappa is None else f64(kappa))
        return torch.squeeze(T_K), torch.squeeze(R_bb)

    def evaluate(self, t_in, f, v_s, M_env, f_rho_M, R, t_exp=0.0, kappa=None):
        if kappa is None:
            kappa = self.kappa
        return super().evaluate(t_in, f, v_s, M_env, f_rho_M, R, t_exp, kappa)

    def _eval_points(self, t, quad, v_s, M_env, f_rho_M, R, t_exp=0.0, kappa=None,
                     plain=False):
        T_K, R_bb = self._tr_points(t, v_s, M_env, f_rho_M, R, t_exp, kappa)
        lum_bb = self._bandflux(quad, T_K, R_bb, plain=plain)
        lum_sup = self._bandflux(quad, 0.74 * T_K, 0.74 ** -2.0 * R_bb, plain=plain)
        return torch.minimum(lum_bb, lum_sup)  # Eq. A4

    def kernel_constants(self):
        """The MSW23 constants the fused SC4 log-posterior evaluates in-kernel."""
        return {"kappa": self.kappa, "A": self.A, "a": self.a, "alpha": self.alpha,
                "L_br_0_42": self.L_br_0 / 1e42, "T_col_br_0": self.T_col_br_0,
                "t_br_0": self.t_br_0, "t_tr_0": self.t_tr_0}

    def t_min(self, p, kappa=None):
        """t_min = 17 min * R + t_exp (MSW23 Eq. A3; reference models.py:634-642)."""
        R = p[3]
        t_exp = p[4] if len(p) > 4 else 0.0
        return self.t_min_0 * R + t_exp

    def t_max(self, p, kappa=None):
        """t_max = min(t_0.7eV, t_tr/a) + t_exp (MSW23 Eq. A3, A8, A9)."""
        if kappa is None:
            kappa = self.kappa
        v_s, M_env, f_rho_M, R = p[0], p[1], p[2], p[3]
        t_exp = p[4] if len(p) > 4 else 0.0
        t_07eV = self.t_07eV_0 * R ** 0.56 * v_s ** 0.16 * kappa ** -0.61 * f_rho_M ** -0.06
        t_tr = self.t_tr_0 * np.sqrt(kappa * M_env / v_s)
        return np.minimum(t_07eV, t_tr / self.a) + t_exp
