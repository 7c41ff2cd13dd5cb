"""Seifert-Beheng two-moment warm-rain microphysics
(``microhh_tpu/ops/microphys.py``; reference ``src/microphys_2mom_warm.cxx``;
SB06 = Seifert & Beheng 2006, SS08 = Stevens & Seifert 2008).

Prognostic rain mass qr and number nr.  ``micro2_plain`` is the JAX
package's op path in torch: masked conversion rates over whole fields, the
SS08 sedimentation as an NSED-deep unrolled sweep of shifted planes and the
downward positivity limiter in closed form (cumsum + cummin).  It is the
plain version of K11 (``csrc/micro2.cu``), which computes the same scheme in
one top-down sweep per column; ``Microphys2momWarm.micro2`` launches K11 on
a CUDA tensor and runs ``micro2_plain`` on a CPU tensor.
"""

import math

import numpy as np
import torch

from .. import constants as cst
from ..kernels import Kernel, check, on_cpu
from .thermo_moist import esat_liq, qsat_liq

# SB06 constants (reference include/microphys_2mom_warm.h:55-70)
RHO_0 = 1.225
QL_MIN = 1.e-6
QR_MIN = 1.e-15
X_STAR = 2.6e-10
PIRHOW = np.pi * cst.rho_w / 6.
MR_MIN = 2.6e-10
MR_MAX = 3e-6
D_V = 3.e-5       # diffusivity of water vapor [m2 s-1]
K_T = 2.5e-2      # thermal conductivity of air

# SS08 rain fall-speed constants (microphys_2mom_warm.cxx:441-447)
W_MAX, A_R, C_R = 9.65, 9.65, 600.
B_R = A_R * np.exp(C_R * 25.0e-6)

# per-level table of K11 (csrc/micro2.cu M_*), the slots of the TPU kernel
(M_RHO, M_RHODZ, M_DZ, M_DZI, M_P, M_EXN, M_LVCPE, M_SQR, M_RHON,
 M_RRHO, N_M) = range(11)

# the deepest sedimentation ring K11 is built for (csrc/micro2.cu NSED_MAX)
NSED_MAX = 8

# the fields whose tendencies K11 adds, in its argument order
MICRO_FIELDS = ("qr", "nr", "qt", "thl")


def _tanh2(x):
    """Rational tanh approximation (microphys_2mom_warm.h:74-78): not a true
    tanh; the reference's mu_r inherits its x/9 tail."""
    return x * (27. + x * x) / (27. + 9. * x * x)


def calc_rain_props(qr, nr, rho):
    """mean mass, diameter, shape mu_r, slope lambda_r."""
    mr = rho * qr / torch.clamp(nr, min=1.)
    mr = torch.clamp(mr, MR_MIN, MR_MAX)
    dr = (mr / PIRHOW) ** (1. / 3.)
    mur = 10. * (1. + _tanh2(1200. * (dr - 0.0015)))
    lamr = ((mur + 3.) * (mur + 2.) * (mur + 1.)) ** (1. / 3.) / dr
    return mr, dr, mur, lamr


def _sedi_pow_pair(mur, lamr):
    """The qr/nr fall-speed powers share the base (1 + c_R/lamr) and their
    exponents differ by 3: one log, one exp and a cube."""
    b = 1. + C_R / lamr
    p4 = torch.exp(-(mur + 4.) * torch.log(b))
    return p4, p4 * (b * b * b)


def _minmod(x, y):
    return torch.sign(x) * torch.clamp(
        torch.minimum(torch.abs(x), torch.sign(x) * y), min=0.)


def ss08_cfl(w_qc, dzi, dt):
    """Half-weights interpolated sedimentation CFL per cell."""
    wp = torch.cat([w_qc[:1], w_qc, torch.zeros_like(w_qc[:1])])
    return 0.25 * (wp[:-2] + 2. * wp[1:-1] + wp[2:]) * dzi * dt


def ss08_flux_tendency(a, c, rho, dz, dzi, dt, nsed, dzi_at_out=False):
    """Limited SS08 flux divergence: (tendency, surface flux > 0).

    The reference's loop over the cells a drop crosses in one dt is an
    nsed-deep unrolled sweep; ``dzi_at_out`` is the reference nr loop's use
    of dzi at the output row (microphys_2mom_warm.cxx:508)."""
    a_dn = torch.cat([a[:1], a[:-1]])
    a_up = torch.cat([a[1:], a[-1:]])
    sl = _minmod(a - a_dn, a_up - a)

    def shift_up(x, m):
        if m == 0:
            return x
        return torch.cat([x[m:], torch.zeros_like(x[:m])])

    rho_b, dz_b, dzi_b, c_b = (torch.broadcast_to(x, a.shape)
                               for x in (rho, dz, dzi, c))
    ftot = torch.zeros_like(a)
    dzz = torch.zeros_like(a)
    cc = torch.clamp(c, max=1.)
    for m in range(nsed):
        active = cc > 0.
        ftot = ftot + torch.where(
            active,
            shift_up(rho_b, m) * (shift_up(a, m) + 0.5 * shift_up(sl, m) * (1. - cc))
            * cc * shift_up(dz_b, m), 0.)
        dzz = dzz + torch.where(active, shift_up(dz_b, m), 0.)
        dzi_next = dzi_b if dzi_at_out else shift_up(dzi_b, m + 1)
        cc = torch.where(active, torch.clamp(shift_up(c_b, m) - dzz * dzi_next,
                                             max=1.), 0.)

    mass = rho_b * dz_b * a
    # downward positivity limiter: ft_k = min(fr_k, ms_k + ft_above) from
    # the top, in closed form ft = S + min(0, cummin(fr - S)), S the
    # top-down running sum of the mass
    fr = torch.flip(ftot, [0])
    S = torch.cumsum(torch.flip(mass, [0]), 0)
    ft = S + torch.clamp(torch.cummin(fr - S, 0).values, max=0.)
    flux = torch.flip(-ft / dt, [0])
    flux_top = torch.cat([flux[1:], torch.zeros_like(flux[:1])])
    tend = -(flux_top - flux) / rho_b * dzi
    return tend, -flux[0]


def micro2_plain(qr, nr, qt, thl, ql, rho, dz, dzi, p, exn, Nc0, dt, nsed):
    """K11 in plain torch: the interior tendencies (qrt, nrt, qtt, thlt) and
    the surface rain rate rr_bot of the 2mom_warm scheme
    (Microphys2momWarm.exec of the JAX package).  Fields are interior
    (ktot, jtot, itot); rho, dz, dzi, p, exn are (ktot, 1, 1) columns."""
    qrt = torch.zeros_like(qr)
    nrt = torch.zeros_like(qr)
    qtt = torch.zeros_like(qr)
    thlt = torch.zeros_like(qr)
    lv_cpe = cst.Lv / (cst.cp * exn)

    # ---- autoconversion (SB06 eq 4; microphys_2mom_warm.cxx:93-128) ----
    nu_c, k_cc = 1., 9.44e9
    kccxs = k_cc / (20. * X_STAR) * (nu_c + 2.) * (nu_c + 4.) / (nu_c + 1.) ** 2
    has_ql = ql > QL_MIN
    xc = rho * ql / Nc0
    tau = 1. - ql / (ql + qr + cst.dsmall)
    phi_au = 600. * tau ** 0.68 * (1. - tau ** 0.68) ** 3
    au = RHO_0 * kccxs * ql ** 2 * xc ** 2 * (1. + phi_au / (1. - tau) ** 2)
    au = torch.where(has_ql, au, 0.)
    qrt += au
    nrt += au * rho / X_STAR
    qtt -= au
    thlt += lv_cpe * au

    # ---- accretion (SB06 eq 7); tau without dsmall (:149) ----
    has_both = has_ql & (qr > QR_MIN)
    tau_ac = 1. - ql / torch.clamp(ql + qr, min=cst.dsmall)
    phi_ac = (tau_ac / (tau_ac + 5e-5)) ** 4
    ac = 5.25 * ql * qr * phi_ac * torch.sqrt(RHO_0 / rho)
    ac = torch.where(has_both, ac, 0.)
    qrt += ac
    qtt -= ac
    thlt += lv_cpe * ac

    # ---- rain properties ----
    mr, dr, mur, lamr = calc_rain_props(qr, nr, rho)
    has_qr = qr > QR_MIN

    # ---- evaporation ----
    T = thl * exn + cst.Lv * ql / (cst.cp * exn)
    Glv = 1. / (cst.Rv * T / (esat_liq(T) * D_V)
                + (cst.Lv / (K_T * T)) * (cst.Lv / (cst.Rv * T) - 1.))
    S = (qt - ql) / qsat_liq(p, T) - 1.
    ev = 2. * np.pi * dr * Glv * S * nr / rho
    ev = torch.where(has_qr, ev, 0.)
    qrt += ev
    nrt += 1.0 * ev * rho / mr
    qtt -= ev
    thlt += lv_cpe * ev

    # ---- selfcollection & breakup (SB06 p49-50) ----
    k_rr, kappa_rr, D_eq = 7.12, 60.7, 0.9e-3
    sc = (-k_rr * nr * qr * rho
          / (1. + kappa_rr / lamr * PIRHOW ** (1. / 3.)) ** 9
          * torch.sqrt(RHO_0 / rho))
    sc = torch.where(has_qr, sc, 0.)
    dDr = dr - D_eq
    phi_br = torch.where(dr <= D_eq, 1.0e3 * dDr, 2. * torch.exp(2.3e3 * dDr) - 1.)
    br = torch.where(has_qr & (dr > 0.35e-3), -(phi_br + 1.) * sc, 0.)
    nrt += sc + br

    # ---- sedimentation (SS08) ----
    rho_n = torch.sqrt(1.2 / rho)
    p4, p1 = _sedi_pow_pair(mur, lamr)
    w_qr = torch.where(has_qr, torch.clamp(rho_n * A_R - B_R * p4, 0.1, W_MAX), 0.)
    w_nr = torch.where(has_qr, torch.clamp(rho_n * A_R - B_R * p1, 0.1, W_MAX), 0.)
    c_qr = ss08_cfl(w_qr, dzi, dt)
    c_nr = ss08_cfl(w_nr, dzi, dt)
    qrt_s, rr_bot = ss08_flux_tendency(qr, c_qr, rho, dz, dzi, dt, nsed)
    nrt_s, _ = ss08_flux_tendency(nr, c_nr, rho, dz, dzi, dt, nsed,
                                  dzi_at_out=True)
    return qrt + qrt_s, nrt + nrt_s, qtt, thlt, rr_bot


class Microphys2momWarm:
    sw = "2mom_warm"

    def __init__(self, ini, grid, fields):
        self.grid = grid
        self.fields = fields
        self.cflmax = ini.get_float("micro", "cflmax", default=2.)
        self.Nc0 = ini.get_float("micro", "Nc0")
        self.swmicrobudget = ini.get_bool("micro", "swmicrobudget", default=False)
        fields.init_prognostic_field("qr", "Rain water mixing ratio", "kg kg-1", "micro")
        fields.init_prognostic_field("nr", "Number density rain", "m-3", "micro")
        fields.sp["qr"].visc = ini.get_float("fields", "svisc", subitem="qr")
        fields.sp["nr"].visc = ini.get_float("fields", "svisc", subitem="nr")
        # the dt limit keeps the sedimentation CFL <= cflmax, so a drop
        # crosses at most ceil(cflmax)+1 cells per step
        self.nsed = int(math.ceil(self.cflmax)) + 2
        self.thermo = None  # wired by Model
        self.k_micro = Kernel("micro2", "microhh_torch/csrc/micro2.cu",
                              "microhh_tpu/ops/microphys_pallas.py:412")

    def table(self, ctx, pref, exnref):
        """K11's per-level table (ktot, N_M) from this substep's pressure
        and Exner profiles (microphys_pallas.Micro2Fused._cc_table)."""
        ks, ke = ctx.ks, ctx.ke
        rho, dz, dzi = ctx.rhoref[ks:ke], ctx.dz[ks:ke], ctx.dzi[ks:ke]
        exn = exnref[ks:ke]
        cols = [None] * N_M
        cols[M_RHO] = rho
        cols[M_RHODZ] = rho * dz
        cols[M_DZ] = dz
        cols[M_DZI] = dzi
        cols[M_P] = pref[ks:ke]
        cols[M_EXN] = exn
        cols[M_LVCPE] = cst.Lv / (cst.cp * exn)
        cols[M_SQR] = torch.sqrt(RHO_0 / rho)
        cols[M_RHON] = torch.sqrt(1.2 / rho)
        cols[M_RRHO] = 1. / rho
        return torch.stack(cols, dim=1).contiguous()

    def apply_plain(self, ctx, s, t, ql, pref, exnref, dt):
        """micro2 with the plain version (micro2_plain) on the model's
        fields: adds the tendencies into t in place, returns rr_bot."""
        ks, ke = ctx.ks, ctx.ke

        def col(a):
            return a[ks:ke][:, None, None]

        tends = micro2_plain(
            s["qr"][ks:ke], s["nr"][ks:ke], s["qt"][ks:ke], s["thl"][ks:ke],
            ql, col(ctx.rhoref), col(ctx.dz), col(ctx.dzi), col(pref),
            col(exnref), self.Nc0, dt, self.nsed)
        for n, tend in zip(MICRO_FIELDS, tends):
            t[n][ks:ke] += tend
        return tends[-1]

    def micro2(self, ctx, s, t, ql, pref, exnref, dt):
        """K11: adds the scheme's tendencies to the interior of t["qr"],
        t["nr"], t["qt"], t["thl"] in place; returns rr_bot (jtot, itot)."""
        if on_cpu(ql):
            return self.apply_plain(ctx, s, t, ql, pref, exnref, dt)
        if self.nsed > NSED_MAX:
            raise ValueError("[micro] cflmax=%g needs a sedimentation ring of "
                             "%d > %d rows (csrc/micro2.cu NSED_MAX)"
                             % (self.cflmax, self.nsed, NSED_MAX))
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        cc = self.table(ctx, pref, exnref)
        fields = [s[n] for n in MICRO_FIELDS] + [t[n] for n in MICRO_FIELDS]
        check(fields + [ql, cc], ql.dtype, ql.device,
              [shape] * 8 + [(ctx.ktot, ctx.jtot, ctx.itot), (ctx.ktot, N_M)])
        rr = torch.empty((ctx.jtot, ctx.itot), dtype=ql.dtype, device=ql.device)
        self.k_micro(ql.dtype, *fields, ql, rr, cc, ctx.itot, ctx.jtot,
                     ctx.ktot, ctx.ks, self.nsed, float(self.Nc0), float(dt))
        return rr

    def exec(self, ctx, s, t, aux, dt):
        """Adds the 2mom_warm tendencies into t in place; aux gains
        rr_bot.  ``dt`` is the whole step's dt, as in the reference."""
        pref, exnref, _, _ = self.thermo._p_profiles(ctx, aux)
        ql = self.thermo.get_ql(ctx, s, aux)
        aux = dict(aux)
        aux["rr_bot"] = self.micro2(ctx, s, t, ql, pref, exnref, dt)
        return t, aux

    def get_time_limit_rate(self, ctx, s):
        """Max sedimentation velocity * dzi; the host multiplies by dt and
        compares with cflmax (calc_max_sedimentation_cfl)."""
        ks, ke = ctx.ks, ctx.ke
        qr = s["qr"][ks:ke]
        rho = ctx.rhoref[ks:ke][:, None, None]
        _, _, mur, lamr = calc_rain_props(qr, s["nr"][ks:ke], rho)
        p4, _ = _sedi_pow_pair(mur, lamr)
        w_qr = torch.where(qr > QR_MIN,
                           torch.clamp(A_R - B_R * p4, 0.1, W_MAX), 0.)
        rate = torch.max(w_qr * ctx.dzi[ks:ke][:, None, None])
        return torch.clamp(rate, min=1e-5)


class MicrophysDisabled:
    sw = "0"
    thermo = None

    def exec(self, ctx, s, t, aux, dt):
        return t, aux

    def get_time_limit_rate(self, ctx, s):
        return None


def make_microphys(ini, grid, fields):
    sw = ini.get_str("micro", "swmicro", default="0")
    if sw in ("0", "false"):
        return MicrophysDisabled()
    if sw == "2mom_warm":
        return Microphys2momWarm(ini, grid, fields)
    if sw == "nsw6":
        from . import not_ported
        raise not_ported("[micro] swmicro=nsw6", 14)
    raise ValueError("%s is an illegal value for swmicro" % sw)
