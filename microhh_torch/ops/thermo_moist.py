"""Moist thermodynamics: thl + qt with saturation adjustment
(``microhh_tpu/ops/thermo_moist.py``; reference ``src/thermo_moist.cxx`` and
``include/thermo_moist_functions.h``).

The saturation functions take a torch tensor (device op path), a numpy
array or scalar (the base state, held bit for bit to the JAX package's numpy
branch) or a Python float (the per-substep base-state update on the host).
``sat_adjust`` keeps the reference's stopping rule: Newton rounds until the
largest |dT|/T over the saturated points is <= 1e-5, at most
NITER_SAT_ADJUST.  On tensors that maximum is read on the host each round;
``ThermoMoist.reads`` counts these reads and the base state's.
"""

import collections
import math

import numpy as np
import torch

from .. import constants as cst
from ..timedep import Timedep
from .stencil import i2

NITER_SAT_ADJUST = 10

# Taylor-expansion coefficients of the Arden Buck (1981) esat_liq
# (reference include/constants.h:73-83).
_ESAT_C = (6.1121000000E+02, 4.4393067270E+01, 1.4279398448E+00,
           2.6415206946E-02, 3.0291749160E-04, 2.1159987257E-06,
           7.5015702516E-09, -1.5604873363E-12, -9.9726710231E-14,
           -4.8165754883E-17, 1.3839187032E-18)


class _Ops:
    """The elementwise primitives of one backend."""

    def __init__(self, maximum, clip, exp, where):
        self.maximum = maximum   # maximum(c, x), c a Python float
        self.clip = clip
        self.exp = exp
        self.where = where


_TORCH = _Ops(lambda c, x: torch.clamp(x, min=c),
              lambda x, lo, hi: torch.clamp(x, lo, hi), torch.exp,
              torch.where)
_NUMPY = _Ops(np.maximum, np.clip, np.exp, np.where)
_FLOAT = _Ops(lambda c, x: x if x > c else c,
              lambda x, lo, hi: lo if x < lo else (hi if x > hi else x),
              math.exp, lambda c, a, b: a if c else b)


def _ops(x):
    if torch.is_tensor(x):
        return _TORCH
    if isinstance(x, (np.ndarray, np.floating)):
        return _NUMPY
    return _FLOAT


def esat_liq(T):
    m = _ops(T)
    x = m.maximum(-75., T - cst.T0)
    acc = _ESAT_C[-1]
    for c in _ESAT_C[-2::-1]:
        acc = c + x * acc
    return acc


def qsat_liq(p, T):
    es = esat_liq(T)
    return cst.ep * es / (p - (1. - cst.ep) * es)


def esat_ice(T):
    m = _ops(T)
    x = m.maximum(-100., T - cst.T0)
    return 611.15 * m.exp(22.452 * x / (272.55 + x))


def qsat_ice(p, T):
    es = esat_ice(T)
    return cst.ep * es / (p - (1. - cst.ep) * es)


def water_fraction(T):
    return _ops(T).clip((T - 233.15) / (cst.T0 - 233.15), 0., 1.)


def qsat(p, T):
    a = water_fraction(T)
    return a * qsat_liq(p, T) + (1. - a) * qsat_ice(p, T)


def dqsatdT_liq(p, T):
    es = esat_liq(T)
    den = p - es * (1. - cst.ep)
    return ((cst.ep / den - (1. + cst.ep) * cst.ep * es / den ** 2)
            * cst.Lv * es / (cst.Rv * T ** 2))


def dqsatdT_ice(p, T):
    es = esat_ice(T)
    den = p - es * (1. - cst.ep)
    return ((cst.ep / den + (1. - cst.ep) * cst.ep * es / den ** 2)
            * cst.Ls * es / (cst.Rv * T ** 2))


def dqsatdT(p, T):
    """Mixed-phase dqsat/dT (thermo_moist_functions.h:165-169)."""
    a = water_fraction(T)
    return a * dqsatdT_liq(p, T) + (1. - a) * dqsatdT_ice(p, T)


def exner(p):
    return (p / cst.p0) ** (cst.Rd / cst.cp)


def virtual_temperature(exn, thl, qt, ql, qi):
    th = thl + cst.Lv * ql / (cst.cp * exn) + cst.Ls * qi / (cst.cp * exn)
    return th * (1. - (1. - cst.Rv / cst.Rd) * qt - cst.Rv / cst.Rd * (ql + qi))


def virtual_temperature_no_ql(thl, qt):
    return thl * (1. - (1. - cst.Rv / cst.Rd) * qt)


def buoyancy(exn, thl, qt, ql, qi, thvref):
    return cst.grav * (virtual_temperature(exn, thl, qt, ql, qi) - thvref) / thvref


def buoyancy_no_ql(thl, qt, thvref):
    return cst.grav * (virtual_temperature_no_ql(thl, qt) - thvref) / thvref


def buoyancy_flux_no_ql(thl, thlflux, qt, qtflux, thvref):
    return cst.grav / thvref * (thlflux * (1. - (1. - cst.Rv / cst.Rd) * qt)
                                - (1. - cst.Rv / cst.Rd) * thl * qtflux)


def _newton_step(m, t, tl, qt, p):
    """One Newton round of the unified warm/cold adjustment."""
    a_w = water_fraction(t)
    a_i = 1. - a_w
    if m is _FLOAT:
        dalphadT = 0.025 if 0. < a_w < 1. else 0.
    else:
        dalphadT = m.where((a_w > 0.) & (a_w < 1.), 0.025, 0.)
    qs_t = qsat(p, t)
    dqw = dqsatdT_liq(p, t)
    dqi = dqsatdT_ice(p, t)
    f = (t - tl - a_w * cst.Lv / cst.cp * qt - a_i * cst.Ls / cst.cp * qt
         + a_w * cst.Lv / cst.cp * qs_t + a_i * cst.Ls / cst.cp * qs_t)
    fp = (1.
          - dalphadT * cst.Lv / cst.cp * qt + dalphadT * cst.Ls / cst.cp * qt
          + dalphadT * cst.Lv / cst.cp * qs_t - dalphadT * cst.Ls / cst.cp * qs_t
          + a_w * cst.Lv / cst.cp * dqw + a_i * cst.Ls / cst.cp * dqi)
    return t - f / fp


def sat_adjust(thl, qt, p, exn, niter=NITER_SAT_ADJUST, reads=None):
    """Saturation adjustment; returns (ql, qi, T, qs).

    Newton with the unified alpha-weighted formulation and the reference's
    stopping rule (|dT|/T <= 1e-5 over the saturated points, at most
    ``niter`` rounds, thermo_moist_functions.h:191-220).  Unsaturated
    points short-circuit to (0, 0, tl, qsat_liq(tl)).  ``reads``: a
    Counter that gains the host reads of the rule on tensors."""
    m = _ops(thl)
    tl = thl * exn
    qs0 = qsat_liq(p, tl)
    unsat = (qt - qs0) <= 0.

    t = tl
    if m is _NUMPY:
        t_old, it = None, 0
        while it < niter and (t_old is None or float(
                np.max(np.where(unsat, 0., np.abs(t - t_old)
                                / np.maximum(np.abs(t_old), 1e-30)))) > 1e-5):
            t_old, t, it = t, _newton_step(m, t, tl, qt, p), it + 1
    elif m is _FLOAT:
        if not unsat:
            for it in range(niter):
                t_old, t = t, _newton_step(m, t, tl, qt, p)
                if abs(t - t_old) / max(abs(t_old), 1e-30) <= 1e-5:
                    break
    else:
        if reads is not None:
            reads["sat_adjust"] += 1
        if not bool(unsat.all()):
            for it in range(1, niter + 1):
                t_old, t = t, _newton_step(m, t, tl, qt, p)
                if it == niter:
                    break
                res = torch.where(unsat, 0., torch.abs(t - t_old)
                                  / torch.clamp(torch.abs(t_old), min=1e-30))
                if reads is not None:
                    reads["sat_adjust"] += 1
                if float(res.max()) <= 1e-5:
                    break

    if m is _FLOAT:
        if unsat:
            return 0., 0., tl, qs0
        a_w = water_fraction(t)
        qs_t = qsat(p, t)
        ql_qi = max(0., qt - qs_t)
        return a_w * ql_qi, (1. - a_w) * ql_qi, t, qs_t
    a_w = water_fraction(t)
    qs_t = qsat(p, t)
    ql_qi = m.maximum(0., qt - qs_t)
    ql = m.where(unsat, 0., a_w * ql_qi)
    qi = m.where(unsat, 0., (1. - a_w) * ql_qi)
    T = m.where(unsat, tl, t)
    qs_out = m.where(unsat, qs0, qs_t)
    return ql, qi, T, qs_out


def _col(a, lo, hi):
    return a[lo:hi][:, None, None]


class ThermoMoist:
    def __init__(self, ini, grid, fields):
        self.grid = grid
        self.fields = fields
        fields.init_prognostic_field("thl", "Liquid water potential temperature", "K", "thermo")
        fields.init_prognostic_field("qt", "Total water mixing ratio", "kg kg-1", "thermo")
        fields.sp["thl"].visc = ini.get_float("fields", "svisc", subitem="thl")
        fields.sp["qt"].visc = ini.get_float("fields", "svisc", subitem="qt")

        sw = ini.get_str("thermo", "swbasestate", default="")
        if sw not in ("boussinesq", "anelastic"):
            raise ValueError('Invalid option for "swbasestate"')
        self.swbasestate = sw
        self.pbot = ini.get_float("thermo", "pbot")
        # reference default: hydrostatic pressure/exner follow the evolving
        # mean state every substep (thermo_moist.cxx:1279-1290); the density
        # and thv references stay at their create() values.
        self.swupdatebasestate = ini.get_bool("thermo", "swupdatebasestate",
                                              default=True)
        # host reads of device values by reason (sat_adjust rounds, base
        # state), for the measurements
        self.reads = collections.Counter()
        # time-dependent surface pressure (thermo_moist.cxx:1041,
        # 1407-1410): p_sbot over time_surface, interpolated on the host
        # every iteration into pbot, which the base-state update reads
        self.swtimedep_pbot = ini.get_bool("thermo", "swtimedep_pbot",
                                           default=False)
        self.tdep_pbot = None
        if sw == "boussinesq":
            self.thvref0 = ini.get_float("thermo", "thvref0")
        else:
            ini.get_float("thermo", "thvref0", default=0.)
        if grid.spatial_order == 4 and sw == "anelastic":
            raise ValueError("Anelastic mode is not supported for swspatialorder=4")

    @property
    def scalars(self):
        return ("thl", "qt")

    def update_timedep(self, sfc, itime):
        """p_sbot at this integer time into pbot (thermo
        update_time_dependent), on the host; sfc as it was."""
        if self.tdep_pbot is not None:
            self.pbot = float(self.tdep_pbot.interpolate(itime))
        return sfc

    def create_basestate(self, input_nc):
        """Moist hydrostatic base state (thermo_moist_functions.h:293-350),
        in numpy float64."""
        if self.swtimedep_pbot:
            self.tdep_pbot = Timedep(input_nc, "p_sbot", "time_surface")
        g = self.grid
        kc, ks, ke = g.kcells, g.kstart, g.kend
        thvref = np.zeros(kc)
        thvrefh = np.zeros(kc)
        pref = np.zeros(kc)
        prefh = np.zeros(kc)

        if self.swbasestate == "boussinesq":
            thvref[:] = self.thvref0
            thvrefh[:] = self.thvref0
            prefh[ks] = self.pbot
            pref[ks] = self.pbot * np.exp(-cst.grav * g.z[ks] / (cst.Rd * thvrefh[ks] * exner(prefh[ks])))
            for k in range(ks + 1, ke + 1):
                prefh[k] = prefh[k - 1] * np.exp(-cst.grav * g.dz[k - 1] / (cst.Rd * thvref[k - 1] * exner(pref[k - 1])))
                pref[k] = pref[k - 1] * np.exp(-cst.grav * g.dzh[k] / (cst.Rd * thvrefh[k] * exner(prefh[k])))
            pref[ks - 1] = 2. * prefh[ks] - pref[ks]
        else:
            init = input_nc.groups["init"]
            thl = np.zeros(kc)
            qt = np.zeros(kc)
            thl[ks:ke] = np.asarray(init.variables["thl"][:g.ktot], dtype=np.float64)
            qt[ks:ke] = np.asarray(init.variables["qt"][:g.ktot], dtype=np.float64)
            thl[ks - 1] = thl[ks]
            qt[ks - 1] = qt[ks]

            rho = np.ones(kc)
            rhoh = np.ones(kc)
            thlsurf = 0.5 * (thl[ks - 1] + thl[ks])
            qtsurf = 0.5 * (qt[ks - 1] + qt[ks])
            prefh[ks] = self.pbot
            exh = exner(prefh[ks])
            ql, qi, _, _ = sat_adjust(np.float64(thlsurf), np.float64(qtsurf),
                                      np.float64(self.pbot), np.float64(exh))
            thvrefh[ks] = virtual_temperature(exh, thlsurf, qtsurf, ql, qi)
            rhoh[ks] = self.pbot / (cst.Rd * exh * thvrefh[ks])
            pref[ks] = prefh[ks] * np.exp(-cst.grav * g.z[ks] / (cst.Rd * exh * thvrefh[ks]))
            for k in range(ks + 1, ke + 1):
                ex = exner(pref[k - 1])
                ql, qi, _, _ = sat_adjust(thl[k - 1], qt[k - 1], pref[k - 1], ex)
                thvref[k - 1] = virtual_temperature(ex, thl[k - 1], qt[k - 1], ql, qi)
                rho[k - 1] = pref[k - 1] / (cst.Rd * ex * thvref[k - 1])
                prefh[k] = prefh[k - 1] * np.exp(-cst.grav * g.dz[k - 1] / (cst.Rd * ex * thvref[k - 1]))
                exh = exner(prefh[k])
                thli = 0.5 * (thl[k - 1] + thl[k]) if k < ke else thl[k - 1]
                qti = 0.5 * (qt[k - 1] + qt[k]) if k < ke else qt[k - 1]
                ql, qi, _, _ = sat_adjust(thli, qti, prefh[k], exh)
                thvrefh[k] = virtual_temperature(exh, thli, qti, ql, qi)
                rhoh[k] = prefh[k] / (cst.Rd * exh * thvrefh[k])
                pref[k] = pref[k - 1] * np.exp(-cst.grav * g.dzh[k] / (cst.Rd * exh * thvrefh[k]))
            pref[ks - 1] = 2. * prefh[ks] - pref[ks]
            self.fields.rhoref = rho
            self.fields.rhorefh = rhoh

        self.thvref = thvref
        self.thvrefh = thvrefh
        self.pref = pref
        self.prefh = prefh
        self.exnref = exner(np.where(pref > 0., pref, cst.p0))
        self.exnrefh = exner(np.where(prefh > 0., prefh, cst.p0))

    def save_basestate(self, iotime, path="."):
        g = self.grid
        with open("%s/thermo_basestate.%07d" % (path, iotime), "wb") as f:
            for arr in (self.thvref, self.thvrefh, self.pref, self.prefh):
                arr[g.kstart:g.kend].tofile(f)

    # ------------------------------------------------------------------
    def update_basestate(self, ctx, s, aux, sfc=None):
        """Hydrostatic pressure and Exner profiles from the horizontal-mean
        thl/qt (thermo_moist_functions.h calc_base_state), into aux.

        The recurrence over k is sequential with a scalar sat_adjust per
        level, so it runs on the host in float64 after one copy of the two
        mean profiles; the profiles go back to the device in the run's
        dtype."""
        if not self.swupdatebasestate:
            return aux
        ks, ke = ctx.ks, ctx.ke
        g = self.grid
        means = torch.stack([s["thl"].mean(dim=(1, 2)),
                             s["qt"].mean(dim=(1, 2))]).double().cpu()
        self.reads["basestate"] += 1
        thlm, qtm = means[0].tolist(), means[1].tolist()
        pbot = float(self.pbot)

        def thv(th, qt, p, ex):
            ql, qi, _, _ = sat_adjust(th, qt, p, ex)
            return virtual_temperature(ex, th, qt, ql, qi)

        thlsurf = 0.5 * (thlm[ks - 1] + thlm[ks])
        qtsurf = 0.5 * (qtm[ks - 1] + qtm[ks])
        exh_s = exner(pbot)
        thvh_s = thv(thlsurf, qtsurf, pbot, exh_s)
        pref = self.pref.copy()
        prefh = self.prefh.copy()
        pref[ks] = p = pbot * math.exp(-cst.grav * float(g.z[ks])
                                       / (cst.Rd * exh_s * thvh_s))
        prefh[ks] = ph = pbot
        for k in range(ks, ke):
            ex = exner(p)
            ph = ph * math.exp(-cst.grav * float(g.dz[k])
                               / (cst.Rd * ex * thv(thlm[k], qtm[k], p, ex)))
            exh = exner(ph)
            thvh = thv(0.5 * (thlm[k] + thlm[k + 1]),
                       0.5 * (qtm[k] + qtm[k + 1]), ph, exh)
            p = p * math.exp(-cst.grav * float(g.dzh[k + 1])
                             / (cst.Rd * exh * thvh))
            pref[k + 1] = p
            prefh[k + 1] = ph
        pref[ks - 1] = 2. * prefh[ks] - pref[ks]
        aux = dict(aux)
        aux["pref"] = ctx.tensor(pref)
        aux["prefh"] = ctx.tensor(prefh)
        aux["exnref"] = ctx.tensor(exner(pref))
        aux["exnrefh"] = ctx.tensor(exner(prefh))
        return aux

    def _p_profiles(self, ctx, aux):
        """(pref, exnref, prefh, exnrefh): the updated profiles from aux
        when swupdatebasestate is active, else the create() base state."""
        if aux is not None and "pref" in aux:
            return aux["pref"], aux["exnref"], aux["prefh"], aux["exnrefh"]
        return (ctx.tensor(self.pref), ctx.tensor(self.exnref),
                ctx.tensor(self.prefh), ctx.tensor(self.exnrefh))

    def exec(self, ctx, s, t, aux):
        """t["w"] += moist buoyancy with sat adjust at the interior half
        levels (thermo_moist.cxx:78-120), in place."""
        ks, ke = ctx.ks, ctx.ke
        thl, qt = s["thl"], s["qt"]
        thlh = i2(thl[ks:ke - 1], thl[ks + 1:ke])
        qth = i2(qt[ks:ke - 1], qt[ks + 1:ke])
        _, _, prefh_a, exnrefh_a = self._p_profiles(ctx, aux)
        ph = _col(prefh_a, ks + 1, ke)
        exnh = _col(exnrefh_a, ks + 1, ke)
        thvrefh = _col(ctx.tensor(self.thvrefh), ks + 1, ke)
        ql, qi, _, _ = sat_adjust(thlh, qth, ph, exnh, reads=self.reads)
        t["w"][ks + 1:ke] += buoyancy(exnh, thlh, qth, ql, qi, thvrefh)
        return t

    def get_buoyancy(self, ctx, s):
        """Full-level buoyancy with condensation on the create() base state
        (calc_buoyancy), zero on the ghost levels; the statistics' budgets
        read it."""
        ks, ke = ctx.ks, ctx.ke
        thl, qt = s["thl"], s["qt"]
        p = _col(ctx.tensor(self.pref), ks, ke)
        exn = _col(ctx.tensor(self.exnref), ks, ke)
        thvref = _col(ctx.tensor(self.thvref), ks, ke)
        ql, qi, _, _ = sat_adjust(thl[ks:ke], qt[ks:ke], p, exn,
                                  reads=self.reads)
        b = torch.zeros_like(thl)
        b[ks:ke] = buoyancy(exn, thl[ks:ke], qt[ks:ke], ql, qi, thvref)
        return b

    def get_ql(self, ctx, s, aux=None):
        """Liquid water on the interior levels."""
        ks, ke = ctx.ks, ctx.ke
        pref_a, exnref_a, _, _ = self._p_profiles(ctx, aux)
        ql, _, _, _ = sat_adjust(s["thl"][ks:ke], s["qt"][ks:ke],
                                 _col(pref_a, ks, ke), _col(exnref_a, ks, ke),
                                 reads=self.reads)
        return ql

    def get_n2(self, ctx, s):
        """N2 from thl (thermo_moist.cxx calc_N2, :460-478): the op path of
        the stability term K1 computes in its moist mode."""
        ks, ke = ctx.ks, ctx.ke
        thl = s["thl"]
        thvref = _col(ctx.tensor(self.thvref), ks, ke)
        return (cst.grav / thvref * 0.5 * (thl[ks + 1:ke + 1] - thl[ks - 1:ke - 1])
                * _col(ctx.dzi, ks, ke))

    def get_buoyancy_fluxbot(self, ctx, s, sfc):
        ks = ctx.ks
        return buoyancy_flux_no_ql(s["thl"][ks], sfc["thl_fluxbot"],
                                   s["qt"][ks], sfc["qt_fluxbot"],
                                   float(self.thvrefh[ks]))

    def get_buoyancy_surf(self, ctx, s, sfc):
        ks = ctx.ks
        b = buoyancy_no_ql(s["thl"][ks], s["qt"][ks], float(self.thvref[ks]))
        bbot = buoyancy_no_ql(sfc["thl_bot"], sfc["qt_bot"],
                              float(self.thvrefh[ks]))
        return b, bbot

    def get_db_ref(self):
        ks = self.grid.kstart
        return float(cst.grav / self.thvref[ks] * (self.thvref[ks] - self.thvrefh[ks]))
